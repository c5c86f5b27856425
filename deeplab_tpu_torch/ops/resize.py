"""TF1 ``resize_bilinear`` and ``resize_nearest_neighbor``
(``align_corners=False``, no half-pixel centers), as in
deeplab_tpu/ops/resize.py.  ``F.interpolate`` uses half-pixel centers and
does not match, so the bilinear resize is two products with the same dense
(out, in) interpolation matrices, in full float32, and the nearest one a
gather at ``floor(d * in / out)``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from deeplab_tpu_torch.parallel import spatial


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


@functools.lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest_tf1(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor, TF1
    ``align_corners=False``: output pixel d takes input ``floor(d * in /
    out)``."""
    ih = torch.from_numpy(_nearest_index(x.shape[-2], int(size[0])))
    iw = torch.from_numpy(_nearest_index(x.shape[-1], int(size[1])))
    return x[..., ih.to(x.device), :][..., iw.to(x.device)]


def _band_matrix(x: torch.Tensor, band, out_h: int):
    """Under ``band``: the band's rows of the whole map's row matrix, and
    ``x`` extended to the input rows they read (output row ``d`` reads
    ``floor(d * in / out)`` and the row after, clamped), fetched from the
    band's neighbours."""
    s_in, s_out = band.level(x.shape[-2]), band.level_of_size(out_h)
    m = _bilinear_matrix(band.size(s_in), out_h)

    def need(j):
        a, b = band.rows(s_out, j)
        cols = np.nonzero(m[a:b].any(axis=0))[0]
        return int(cols[0]), int(cols[-1]) + 1
    g0, g1 = need(band.index)
    a, b = band.rows(s_out)
    return (spatial.exchange(x, band, s_in, need),
            np.ascontiguousarray(m[a:b, g0:g1]))


def resize_bilinear_tf1(x: torch.Tensor, size, band=None) -> torch.Tensor:
    """Resize an NCHW tensor to ``size=(H_out, W_out)`` with TF1 semantics.
    Computes in float32 and returns ``x``'s dtype, like the JAX op.  Under
    ``band`` (``parallel/spatial.py``) ``x`` is a band of the map and
    ``size`` the whole output's; the result is the band's rows of it."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = spatial.map_height(x, band), x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    if band is None:
        mh = _bilinear_matrix(in_h, out_h)
    else:
        x, mh = _band_matrix(x, band, out_h)
    mh = torch.from_numpy(mh).to(x.device)
    mw = torch.from_numpy(_bilinear_matrix(in_w, out_w)).to(x.device)
    y = torch.matmul(mh, x.float())          # (..., out_h, in_w)
    y = torch.matmul(y, mw.t())               # (..., out_h, out_w)
    return y.to(x.dtype)
