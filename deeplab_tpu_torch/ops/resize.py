"""TF1 ``resize_bilinear`` (``align_corners=False``, no half-pixel centers),
as in deeplab_tpu/ops/resize.py.  ``F.interpolate`` uses half-pixel centers
and does not match, so the resize is two products with the same dense
(out, in) interpolation matrices, in full float32."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-stochastic interpolation matrix, TF1 align_corners=False."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    for d in range(out_size):
        src = d * scale
        lo = min(int(np.floor(src)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[d, lo] += 1.0 - frac
        m[d, hi] += frac
    return m


def resize_bilinear_tf1(x: torch.Tensor, size) -> torch.Tensor:
    """Resize an NCHW tensor to ``size=(H_out, W_out)`` with TF1 semantics.
    Computes in float32 and returns ``x``'s dtype, like the JAX op."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    mh = torch.from_numpy(_bilinear_matrix(in_h, out_h)).to(x.device)
    mw = torch.from_numpy(_bilinear_matrix(in_w, out_w)).to(x.device)
    y = torch.matmul(mh, x.float())          # (..., out_h, in_w)
    y = torch.matmul(y, mw.t())               # (..., out_h, out_w)
    return y.to(x.dtype)
