"""Serving API: images -> model -> argmax -> dense CRF
(deeplab_tpu/predictor.py, no mesh).

Meshes, spatial sharding and test-time augmentation are later slices and
raise ``NotImplementedError`` here rather than run something else.
"""

from __future__ import annotations

import torch

from deeplab_tpu_torch import core
from deeplab_tpu_torch.crf import dense_crf


class Predictor:
    """``Predictor(net, crf=None, compute_dtype="mixed", device=None)``.

    ``net``: a :class:`~deeplab_tpu_torch.models.seg_model.SegNet` with its
    weights; it is moved to ``device`` and put in eval mode.  ``device``
    defaults to the card and raises if there is none.  ``compute_dtype``:
    ``"mixed"`` (the serving policy), ``"float32"`` or ``"bfloat16"``.
    ``crf``: a :class:`~deeplab_tpu_torch.crf.CrfConfig` refines the argmax
    on the device (``crf.PRODUCTION_CONFIG`` is the production path), or
    None.  ``return_raw`` (with a CRF) returns ``(raw, refined)`` from one
    model forward."""

    def __init__(self, net, crf=None, compute_dtype="mixed", device=None,
                 mesh=None, spatial: bool = False, return_raw: bool = False,
                 tta_scales=None, tta_flip: bool = False):
        later = {"mesh": (mesh is not None, "the multi-GPU slice"),
                 "spatial": (spatial, "the multi-GPU slice"),
                 "tta": (bool(tta_scales) or tta_flip,
                         "the serving-surface slice")}
        for name, (asked, where) in later.items():
            if asked:
                raise NotImplementedError(f"Predictor {name} is not ported "
                                          f"yet: it comes with {where}")
        if crf is not None:
            dense_crf.check_supported(crf, net.sz)
        self.crf = crf
        self.return_raw = return_raw and crf is not None
        self.device = core.resolve_device(device)
        self.policy = core.resolve_compute_dtype(compute_dtype)
        self.net = net.to(self.device).eval()

    def __call__(self, images):
        """images: (B, H, W, 3) raw 0-255 BGR (numpy or tensor) -> (B, H, W)
        int32 label maps as a numpy array, CRF-refined when configured; with
        ``return_raw`` a ``(raw, refined)`` pair of them."""
        img = torch.as_tensor(images).to(self.device, torch.float32)
        with torch.inference_mode():
            raw = self.net.predict_ids(img, self.policy)
            preds = raw
            if self.crf is not None:
                # the CRF sees the raw 0-255 image, as in the JAX pipeline
                preds = dense_crf.mean_field_batched(img, raw, self.crf,
                                                     self.net.n_classes)
        if self.return_raw:
            return raw.cpu().numpy(), preds.cpu().numpy()
        return preds.cpu().numpy()
