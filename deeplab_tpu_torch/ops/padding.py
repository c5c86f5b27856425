"""Padding math of the reference's two padding regimes (a copy of
deeplab_tpu/ops/padding.py; the port keeps its own).

1. Keras ``padding='same'`` (TF SAME): ``pad_total = max((ceil(in/s)-1)*s +
   eff_k - in, 0)``, split low-first (``lo = total//2``).  Asymmetric for
   stride 2 on even sizes: 512 with k=3, s=2 pads (0, 1).
2. The manual "fixed" padding: ``pad_total = eff_k - 1`` regardless of input
   size (reference ``ZeroPadding2D`` + VALID).

torch's ``padding=`` argument pads both sides alike, so the port always pads
with ``F.pad`` and runs a VALID conv.
"""

from __future__ import annotations

import math


def effective_kernel(kernel_size: int, rate: int) -> int:
    return kernel_size + (kernel_size - 1) * (rate - 1)


def same_pads(in_size: int, kernel_size: int, stride: int, rate: int = 1):
    """TF/Keras SAME padding (lo, hi) for one spatial dim."""
    eff_k = effective_kernel(kernel_size, rate)
    out = math.ceil(in_size / stride)
    pad_total = max((out - 1) * stride + eff_k - in_size, 0)
    lo = pad_total // 2
    return (lo, pad_total - lo)


def manual_pads(kernel_size: int, rate: int = 1):
    """Reference's fixed padding: input-size independent."""
    pad_total = effective_kernel(kernel_size, rate) - 1
    beg = pad_total // 2
    return (beg, pad_total - beg)


def conv_out_size(in_size: int, kernel_size: int, stride: int, rate: int,
                  pads) -> int:
    eff_k = effective_kernel(kernel_size, rate)
    return (in_size + pads[0] + pads[1] - eff_k) // stride + 1
