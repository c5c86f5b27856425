"""Plain dense-CRF mean field in PyTorch, float32, for the benchmark's
comparisons.

The mean field of Kraehenbuehl & Koltun (arXiv:1210.5644, Algorithm 1)
with the pydensecrf parameters of the reference code (spatial Gaussian
sxy 3, compat 3; bilateral sxy 80, srgb 13, compat 10; 5 iterations; a
two-level unary from hard labels at gt_prob 0.7) on the approximation the
deployment configures (``crf`` in a configuration file, the fields of
``PRODUCTION_CONFIG``):

- the image is cut into cells (the largest divisor of H in
  [sxy/2, sxy] rows, 128 columns for sxy >= 80);
- the bilateral kernel is a bilateral grid per cell: every
  ``splat_stride``-th pixel per axis splats its value (times stride^2)
  with trilinear hat weights onto a color lattice of step
  ``srgb * color_step`` (nc bins an axis); the lattices are blurred across
  cells with Gaussian band taps at the cells' spacing, and along each color
  axis with the configured band taps (``nnls`` or ``lsq`` fits of the
  Gaussian through the hat basis, or samples); every pixel slices its
  message back with the same hat weights;
- normalization is symmetric: 1/sqrt(K 1 - self weight) on both sides, the
  self weight in closed form, floored at itself when the splat is
  subsampled;
- the spatial kernel is a truncated separable Gaussian (radius ceil(2.5
  sigma)) over the whole image, zero outside it, normalized the same way.

All arithmetic is float32 (the caller turns TF32 off).  ``quant`` rounds
the mean-field state and every splatted grid (a lower precision for a
control run).  This module imports torch, numpy and scipy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gauss_taps(sigma: float) -> np.ndarray:
    r = int(math.ceil(2.5 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    return np.exp(-0.5 * (x / sigma) ** 2)


def blur_taps(step: float) -> np.ndarray:
    r = max(1, int(math.ceil(2.2 / step)))
    d = np.arange(-r, r + 1, dtype=np.float64)
    return np.exp(-0.5 * (d * step) ** 2)


def color_taps(step: float, mode: str, radius: int, range_sigmas: float):
    """Band taps of the color blur: Gaussian samples, or the least-squares
    (``lsq``) or nonnegative least-squares (``nnls``) fit of the Gaussian
    kernel over ``range_sigmas`` sigmas through the 2-tap hat basis."""
    if mode == "gaussian":
        return blur_taps(step)
    R, h = float(range_sigmas), float(step)
    nc = int(math.floor(R / h)) + 2
    xs = np.linspace(0.0, R, 768)
    P = np.maximum(0.0, 1.0 - np.abs(xs[:, None] / h - np.arange(nc)[None]))
    K = np.exp(-0.5 * (xs[:, None] - xs[None, :]) ** 2)
    feats = []
    for k in range(radius + 1):
        Bk = np.zeros((nc, nc))
        i = np.arange(0, nc - k)
        Bk[i, i + k] = 1.0
        if k:
            Bk[i + k, i] = 1.0
        feats.append((P @ Bk @ P.T).ravel())
    A = np.stack(feats, axis=1)
    if mode == "nnls":
        from scipy.optimize import nnls
        t, _ = nnls(A, K.ravel())
    else:
        t, *_ = np.linalg.lstsq(A, K.ravel(), rcond=None)
    taps = np.zeros(2 * radius + 1)
    taps[radius] = t[0]
    for k in range(1, radius + 1):
        taps[radius - k] = taps[radius + k] = t[k]
    return taps


def band(n: int, taps) -> np.ndarray:
    """(n, n) banded matrix, m[i, i + k] = taps[R + k]."""
    r = len(taps) // 2
    m = np.zeros((n, n))
    for off, t in zip(range(-r, r + 1), taps):
        i = np.arange(max(0, -off), min(n, n - off))
        m[i, i + off] = t
    return m


class Geometry:
    """The cells, lattice and taps of (h, w) images at configuration
    ``c`` (a dict of the CRF fields)."""

    def __init__(self, h: int, w: int, c: dict):
        sxy = c["sxy_bilateral"]
        cs = max(int(round(sxy)), 1)
        self.cs_y = next((d for d in range(cs, max(cs // 2, 1) - 1, -1)
                          if h % d == 0), cs)
        self.cs_x = 128 if cs >= 80 else cs
        step = c["srgb"] * c["color_step"]
        self.nc = int(math.floor(255.0 / step)) + 2
        self.inv_step = 1.0 / step
        self.ny, self.nx = -(-h // self.cs_y), -(-w // self.cs_x)
        s = c["splat_stride"]
        self.stride = (s if s > 1 and self.cs_y % s == 0
                       and self.cs_x % s == 0 else 1)
        self.h, self.w = h, w
        self.S = np.kron(band(self.ny, blur_taps(self.cs_y / sxy)),
                         band(self.nx, blur_taps(self.cs_x / sxy)))
        self.ctaps = color_taps(c["color_step"], c["color_taps"],
                                c["color_taps_radius"], 255.0 / c["srgb"])
        self.gtaps = gauss_taps(c["sxy_gaussian"])


def _cells(x, g: Geometry):
    """(ch, H, W) -> (Z, ch, cs_y, cs_x), zero-padded to whole cells."""
    ch = x.shape[0]
    x = F.pad(x, (0, g.nx * g.cs_x - g.w, 0, g.ny * g.cs_y - g.h))
    return (x.reshape(ch, g.ny, g.cs_y, g.nx, g.cs_x)
            .permute(1, 3, 0, 2, 4).reshape(-1, ch, g.cs_y, g.cs_x))


def _uncells(x, g: Geometry):
    """(Z, ch, cs_y, cs_x) -> (ch, H, W)."""
    ch = x.shape[1]
    return (x.reshape(g.ny, g.nx, ch, g.cs_y, g.cs_x).permute(2, 0, 3, 1, 4)
            .reshape(ch, g.ny * g.cs_y, g.nx * g.cs_x))[:, :g.h, :g.w]


def _hat(coord, nc: int):
    """(Z, P) lattice coordinates -> (Z, nc, P) hat weights."""
    bins = torch.arange(nc, dtype=coord.dtype, device=coord.device)
    return torch.clamp(1.0 - (bins[None, :, None] - coord[:, None]).abs(),
                       min=0.0)


class Lattice:
    """The bilateral grid of one image: splat, blur, slice."""

    def __init__(self, rgb, g: Geometry, quant=None):
        self.g, self.quant = g, quant
        dev = rgb.device
        coords = _cells(rgb * g.inv_step, g)               # (Z, 3, cy, cx)
        self.coords = coords.flatten(2)                     # (Z, 3, P)
        s = g.stride
        self.coords_sub = coords[:, :, ::s, ::s].flatten(2)
        self.S = torch.tensor(g.S, dtype=torch.float32, device=dev)
        nc = g.nc
        self.Bc = torch.tensor(band(nc, g.ctaps), dtype=torch.float32,
                               device=dev)

    def _weights(self, coords):
        nc = self.g.nc
        h0, h1, h2 = (_hat(coords[:, i], nc) for i in range(3))
        rg = (h0[:, :, None] * h1[:, None]).flatten(1, 2)   # (Z, nc^2, P)
        return rg, h2

    def filter(self, v_sub):
        """(Z, L, P_sub) values of the splatting pixels -> (Z, L, P): the
        grid's message at every pixel, self contribution included."""
        Z, L, Ps = v_sub.shape
        nc = self.g.nc
        rg, h2 = self._weights(self.coords_sub)
        t = (h2[:, :, None] * v_sub[:, None]).reshape(Z, nc * L, Ps)
        G = torch.matmul(t, rg.transpose(1, 2))             # (Z, nc*L, nc^2)
        if self.quant is not None:
            G = self.quant(G)
        G = torch.matmul(self.S.t(), G.reshape(Z, -1)).reshape(G.shape)
        Bc = self.Bc
        G = G.reshape(Z, nc, L, nc, nc)                     # (z, b, l, r, g)
        G = torch.einsum("zblrg,rs->zblsg", G, Bc)
        G = torch.einsum("zblsg,gt->zblst", G, Bc)
        G = torch.einsum("zblst,bc->zclst", G, Bc)
        rg, h2 = self._weights(self.coords)
        out = []
        for z0 in range(0, Z, 8):
            zz = slice(z0, z0 + 8)
            m = torch.matmul(G[zz].reshape(-1, nc * L, nc * nc), rg[zz])
            m = m.reshape(-1, nc, L, rg.shape[-1])
            out.append((m * h2[zz][:, :, None]).sum(1))
        return torch.cat(out)

    def self_weight(self):
        """(Z, 1, P) closed-form self weight of the splat, blur and slice."""
        frac = self.coords - torch.floor(self.coords)
        s0, s1 = 1.0 - frac, frac
        r = len(self.g.ctaps) // 2
        b0, b1 = float(self.g.ctaps[r]), float(self.g.ctaps[r + 1])
        per = (s0 * s0 + s1 * s1) * b0 + 2.0 * s0 * s1 * b1
        return per.prod(dim=1, keepdim=True)


def _sep_blur(x, taps):
    """Separable truncated Gaussian over (ch, H, W), zero outside."""
    k = torch.tensor(taps, dtype=torch.float32, device=x.device)
    r = len(taps) // 2
    y = F.conv2d(x[:, None], k.view(1, 1, -1, 1), padding=(r, 0))
    return F.conv2d(y, k.view(1, 1, 1, -1), padding=(0, r))[:, 0]


def mean_field(img, labels, c: dict, n_labels: int, quant=None):
    """The mean field's final Q (L, H, W) of one image; its argmax over L
    is the refined labels.  ``img`` (H, W, 3) float32 0-255, ``labels``
    (H, W) ints in [0, n_labels)."""
    h, w = labels.shape
    g = Geometry(h, w, c)
    L, s = n_labels, g.stride
    dev = img.device
    q = quant if quant is not None else (lambda t: t)
    lat = Lattice(img.permute(2, 0, 1).float(), g, quant)
    ones = torch.ones((1, h, w), device=dev)
    gsum = _sep_blur(ones, g.gtaps) - 1.0
    gn = _cells(torch.rsqrt(torch.clamp(gsum, min=1e-20)), g).flatten(2)
    valid = _cells(ones, g)
    v_sub = valid[:, :, ::s, ::s].flatten(2) * float(s * s)
    b_self = lat.self_weight()
    filt = lat.filter(v_sub)
    floor = b_self if s > 1 else torch.full_like(b_self, 1e-20)
    bn = torch.rsqrt(torch.maximum(filt - b_self, floor))
    bscale = bn * valid.flatten(2) * float(s * s)
    n_e = -math.log((1.0 - c["gt_prob"]) / (L - 1))
    p_e = -math.log(c["gt_prob"])
    lab = _cells(labels[None].float(), g).flatten(2)        # (Z, 1, P)
    iota = torch.arange(L, device=dev, dtype=torch.float32)[None, :, None]
    U = torch.where(iota == lab, p_e, n_e)
    Q = q(torch.softmax(-U, dim=1))
    cy, cx = g.cs_y, g.cs_x
    for _ in range(c["n_iters"]):
        A = Q * gn
        img_A = _uncells(A.reshape(-1, L, cy, cx), g)
        f_g = _cells(_sep_blur(img_A, g.gtaps), g).flatten(2)
        msg_g = (f_g - A) * gn
        V = (Q * bscale).reshape(-1, L, cy, cx)[:, :, ::s, ::s].flatten(2)
        msg_b = torch.clamp(lat.filter(V) - b_self * bn * Q, min=0.0) * bn
        logits = -U + c["compat_gaussian"] * msg_g \
            + c["compat_bilateral"] * msg_b
        Q = q(torch.softmax(logits, dim=1))
    return _uncells(Q.reshape(-1, L, cy, cx), g)
