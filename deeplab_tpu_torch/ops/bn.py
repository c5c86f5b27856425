"""Eval-mode BatchNormalization with Keras semantics (deeplab_tpu/ops/bn.py).

Per-layer epsilon: 1e-3 in the MobileNetV2 trunk, 1e-5 in ASPP.  ``gamma`` and
``beta`` are parameters; the moving statistics are buffers.  Training-mode
BN (batch statistics, the momentum-0.999 EMA) belongs to the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from deeplab_tpu_torch.ops import init as inits


def bn_scale_shift(bn: "BatchNorm"):
    """Folded eval affine ``(scale, shift)`` in float32."""
    scale = bn.gamma.float() * torch.rsqrt(bn.moving_variance.float() + bn.eps)
    return scale, bn.beta.float() - bn.moving_mean.float() * scale


class BatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-3, gen=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(inits.ones(gen, (channels,)))
        self.beta = nn.Parameter(inits.zeros(gen, (channels,)))
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_variance", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW.  Normalizes with the moving statistics."""
        if self.training:
            raise NotImplementedError("training-mode BatchNorm is not ported "
                                      "yet (training slice); call .eval()")
        scale, shift = bn_scale_shift(self)
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])
