"""SegNet with the ``'original'`` head (deeplab_tpu/models/seg_model.py).

The MobileNetV2 DeepLabV3+ trunk, truncated at the post-Dropout ASPP
projection, then the 1x1 ``conv_upsample`` to ``n_classes`` and a TF1
bilinear resize to the input size.  Every layer is a submodule named after
its Keras layer, so loading weights is a walk over names (params.py).
"""

from __future__ import annotations

import torch
from torch import nn

from deeplab_tpu_torch import core
from deeplab_tpu_torch.models import deeplabv3p, mobilenetv2
from deeplab_tpu_torch.ops.conv import Conv2D
from deeplab_tpu_torch.ops.resize import resize_bilinear_tf1


class SegNet(nn.Module):
    """``SegNet(image_size, n_classes)``; weights are glorot-uniform from
    ``torch.Generator().manual_seed(seed)`` with BN at identity statistics,
    like a fresh Keras model, until params.py loads real ones.

    ``fuse_blocks=False`` keeps every block on the plain layer composition
    (the yardstick the fused kernel path is compared with)."""

    def __init__(self, image_size, n_classes: int, backbone: str = "mobilenetv2",
                 net: str = "original", alpha: float = 1.0, seed: int = 0,
                 fuse_blocks: bool = True):
        super().__init__()
        if backbone != "mobilenetv2" or net != "original":
            raise NotImplementedError(
                "only the MobileNetV2 trunk with the 'original' head is "
                "ported; Xception and the subpixel head are a later slice")
        self.sz = tuple(image_size)
        self.n_classes = n_classes
        self.backbone, self.net, self.alpha = backbone, net, alpha
        self.fuse_blocks = fuse_blocks
        gen = torch.Generator().manual_seed(seed)
        c = mobilenetv2.build_backbone(self.add_module, gen, alpha)
        c = deeplabv3p.build_aspp(self.add_module, gen, c)
        self.conv_upsample = Conv2D(c, n_classes, 1, use_bias=True, gen=gen)
        # channels-last memory: NHWC is the layout of the inputs and of the
        # fused kernel; 1x1 convs are then (pixels x C) products
        self.to(memory_format=torch.channels_last)

    @property
    def layer_order(self):
        """Layer names in Keras graph order (JAX ``SegNet.layer_order``),
        which the freeze policy counts from."""
        return tuple(name for name, _ in self.named_children())

    def _logits_nchw(self, img, policy, gen=None):
        feats = deeplabv3p.deeplabv3_forward(self, img, policy, gen)
        x = self.conv_upsample(feats, policy)
        return resize_bilinear_tf1(x, self.sz)

    def apply_logits(self, img: torch.Tensor, compute_dtype="float32",
                     gen=None):
        """(B, H, W, 3) BGR 0-255 -> (B, H, W, n) head logits in the compute
        dtype, under autograd (JAX ``SegNet.apply_logits``).  In training
        mode BN uses batch statistics and updates its moving statistics,
        and dropout draws from ``gen``."""
        policy = core.resolve_compute_dtype(compute_dtype)
        with core.precision_flags(policy):
            return self._logits_nchw(img, policy, gen).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def logits(self, img: torch.Tensor, compute_dtype="float32"):
        """(B, H, W, 3) BGR 0-255 -> (B, H, W, n) head logits in the compute
        dtype (JAX ``SegNet.apply_logits``, eval mode)."""
        policy = core.resolve_compute_dtype(compute_dtype)
        with core.precision_flags(policy):
            return self._logits_nchw(img, policy).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def predict_ids(self, img: torch.Tensor, compute_dtype="float32"):
        """(B, H, W, 3) -> (B, H, W) int32 argmax of the head logits (the
        softmax is per-pixel monotone, so it is skipped)."""
        policy = core.resolve_compute_dtype(compute_dtype)
        with core.precision_flags(policy):
            logits = self._logits_nchw(img, policy)
        return torch.argmax(logits, dim=1).to(torch.int32)
