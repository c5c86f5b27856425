"""Sub-pixel phase shift in the reference's channel order
(deeplab_tpu/ops/pixel_shuffle.py), on NCHW tensors:

    out[b, f, h*r + dr, w*r + dc] = in[b, f*r*r + dc*r + dr, h, w]

The channel index is ``f*r^2 + dc*r + dr`` (column offset before row
offset).  ``nn.PixelShuffle`` reads ``f*r^2 + dr*r + dc`` and does not match
the shipped ``mobilenetv2_subpixel.h5``, so it is not used.
"""

from __future__ import annotations

import torch


def phase_shift(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, f*r*r, H, W) -> (B, f, H*r, W*r)."""
    b, c, h, w = x.shape
    f = c // (r * r)
    if f * r * r != c:
        raise ValueError(f"channels {c} not divisible by r^2={r * r}")
    x = x.reshape(b, f, r, r, h, w)            # (b, f, dc, dr, h, w)
    x = x.permute(0, 1, 4, 3, 5, 2)            # (b, f, h, dr, w, dc)
    return x.reshape(b, f, h * r, w * r)


def phase_shift_inverse(y: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of :func:`phase_shift`: (B, f, H*r, W*r) -> (B, f*r*r,
    H, W)."""
    b, f, hr, wr = y.shape
    h, w = hr // r, wr // r
    y = y.reshape(b, f, h, r, w, r)            # (b, f, h, dr, w, dc)
    y = y.permute(0, 1, 5, 3, 2, 4)            # (b, f, dc, dr, h, w)
    return y.reshape(b, f * r * r, h, w)
