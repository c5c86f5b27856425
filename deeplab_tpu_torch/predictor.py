"""Serving API: images -> model -> argmax (deeplab_tpu/predictor.py, no mesh).

The port serves the pipeline without post-processing; the dense CRF, meshes,
spatial sharding, ``return_raw`` and test-time augmentation are later slices
and raise ``NotImplementedError`` here rather than run something else.
"""

from __future__ import annotations

import torch

from deeplab_tpu_torch import core


class Predictor:
    """``Predictor(net, compute_dtype="mixed", device=None)``.

    ``net``: a :class:`~deeplab_tpu_torch.models.seg_model.SegNet` with its
    weights; it is moved to ``device`` and put in eval mode.  ``device``
    defaults to the card and raises if there is none.  ``compute_dtype``:
    ``"mixed"`` (the serving policy), ``"float32"`` or ``"bfloat16"``."""

    def __init__(self, net, crf=None, compute_dtype="mixed", device=None,
                 mesh=None, spatial: bool = False, return_raw: bool = False,
                 tta_scales=None, tta_flip: bool = False):
        later = {"crf": (crf is not None, "slice 2 (the production CRF)"),
                 "mesh": (mesh is not None, "the multi-GPU slice"),
                 "spatial": (spatial, "the multi-GPU slice"),
                 "return_raw": (return_raw, "slice 2 (the production CRF)"),
                 "tta": (bool(tta_scales) or tta_flip,
                         "the serving-surface slice")}
        for name, (asked, where) in later.items():
            if asked:
                raise NotImplementedError(f"Predictor {name} is not ported "
                                          f"yet: it comes with {where}")
        self.device = core.resolve_device(device)
        self.policy = core.resolve_compute_dtype(compute_dtype)
        self.net = net.to(self.device).eval()

    def __call__(self, images):
        """images: (B, H, W, 3) raw 0-255 BGR (numpy or tensor) -> (B, H, W)
        int32 label maps, as a numpy array."""
        img = torch.as_tensor(images).to(self.device, torch.float32)
        with torch.inference_mode():
            out = self.net.predict_ids(img, self.policy)
        return out.cpu().numpy()
