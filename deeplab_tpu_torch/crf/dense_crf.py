"""Fully-connected CRF mean field (deeplab_tpu/crf/dense_crf.py), on both
of its engines.

The mean field of Krähenbühl & Koltun (Algorithm 1) with the reference's
pydensecrf parameters (utils.py:74-91): a unary from hard labels (or the
caller's energies), a truncated separable spatial Gaussian and a
bilateral-grid bilateral kernel, symmetric normalization, self-interaction
excluded.  The bilateral grid of a cell is ``(D, C)`` with ``d = b*L + l``
and ``c = r*nc + g``; images live in pixel-major *cell planes*
``(B*Z, ch, P)``: cut into ``cs_y x cs_x`` cells, Z per image, P pixels each.

- The plane engine (``backend="auto"`` or ``"pallas"``; ``CellPlan``): cells
  of 128 px in x (``round(sxy)`` below sxy 80), and per request the
  hand-written kernels of ``kernels/crf_fused.py``: ``splat_planes`` (the
  norm pass and once per iteration), ``slice_attrs_planes`` (once), the
  spatial blur and ``mf_step_planes`` (once per iteration), the latter with
  the two-level unary from the label row (``mean_field_batched``) or an
  explicit unary stream (``mean_field``, ``do_crf``).  The spatial blur runs
  on the cell planes where the cells are 128 px wide and the Gaussian's
  radius fits in a cell: ``gaussian_blur_planes``, its fused row kernel or,
  at other cell heights and radii past 16, its y and x passes.  Narrower
  cells take the image-layout blur, two bf16 band products.  The
  cross-cell grid blur ``CellPlan.z_blur`` is a plain batched Z x Z
  product.
- The XLA engine (``backend="xla"``; ``BilateralPlan``): square cells of
  ``round(sxy)`` px, one image at a time, the spatial message as band
  products in image layout; each bilateral filter is ``splat_planes`` (f32),
  a Z x Z product and ``slice_planes``: 6 of each per ``mean_field``.

Ported, at every configuration and image size: ``mean_field_batched`` (the
plane engine batched, the XLA engine per image), ``mean_field``, ``do_crf``
(each with ``resolution_scale``: the CRF at 1/s resolution with both
``sxy_*`` divided by s, nearest-upsampled back), ``bilateral_filter`` and its
norm, self-weight and message.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from deeplab_tpu_torch import core
from deeplab_tpu_torch.core import annotate
from deeplab_tpu_torch.kernels import crf_fused as K
from deeplab_tpu_torch.kernels.crf_fused import band_matrix_np


@dataclasses.dataclass(frozen=True)
class CrfConfig:
    """Same fields and defaults as the JAX ``CrfConfig``.  ``backend``:
    ``"auto"`` and ``"pallas"`` run the port's plane engine, ``"xla"`` its
    XLA engine (the JAX package's ``_BilateralPlan``, on the port's
    kernels)."""
    sxy_gaussian: float = 3.0
    compat_gaussian: float = 3.0
    sxy_bilateral: float = 80.0
    srgb: float = 13.0
    compat_bilateral: float = 10.0
    n_iters: int = 5
    gt_prob: float = 0.7
    # grid spacing of the color axes in units of srgb
    color_step: float = 1.0
    # splat from every s-th pixel per axis (x s^2 weight)
    splat_stride: int = 1
    # run at 1/s resolution and upsample
    resolution_scale: int = 1
    # color-blur quadrature: "gaussian", "lsq" or "nnls" band taps
    color_taps: str = "gaussian"
    color_taps_radius: int = 2
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"backend must be 'auto', 'xla' or 'pallas', "
                f"got {self.backend!r}")
        if self.color_taps not in ("gaussian", "lsq", "nnls"):
            raise ValueError(f"color_taps must be 'gaussian', 'lsq' or "
                             f"'nnls', got {self.color_taps!r}")


def unary_from_labels(labels: torch.Tensor, n_labels: int, gt_prob: float,
                      zero_unsure: bool = True) -> torch.Tensor:
    """(N,) int labels -> (N, L) unary energies (pydensecrf semantics)."""
    labels = labels.reshape(-1)
    n_energy = -math.log((1.0 - gt_prob) / (n_labels - 1))
    p_energy = -math.log(gt_prob)
    idx = labels - 1 if zero_unsure else labels
    one_hot = (idx[:, None] == torch.arange(n_labels, device=labels.device)
               ).float()
    U = n_energy + (p_energy - n_energy) * one_hot
    if zero_unsure:
        U = torch.where((labels == 0)[:, None], -math.log(1.0 / n_labels), U)
    return U


# ------------------------------------------------------ spatial Gaussian ----

def _gauss_taps(sigma: float) -> np.ndarray:
    radius = int(math.ceil(2.5 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    return np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _band_matrix(n: int, taps: tuple, device) -> torch.Tensor:
    return torch.from_numpy(band_matrix_np(n, np.asarray(taps, np.float32))
                            ).to(device)


def _sep_conv_hw(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable spatial filter over (H, W, L) f32: two products with banded
    (out = in) matrices in f32, TF32 off (the caller's precision flags), as
    the JAX package runs them at HIGHEST precision."""
    h, w, _ = x.shape
    taps = tuple(float(t) for t in taps)
    th = _band_matrix(h, taps, x.device)
    tw = _band_matrix(w, taps, x.device)
    y = torch.einsum("ih,hwl->iwl", th, x)
    return torch.einsum("jw,hwl->hjl", tw, y)


def _sep_conv_bwh_to_bhw(x: torch.Tensor, taps) -> torch.Tensor:
    """The plane engine's image-layout spatial filter, (B, L, W, H) ->
    (B, L, H, W) bf16: right products with the bf16-rounded band matrices
    over H, then over W, each rounded to bf16 (JAX
    ``_sep_conv_bwh_to_bhw``).  Computed as f32 products of the bf16-valued
    operands, TF32 off (the caller's precision flags), then rounded."""
    b, l, w, h = x.shape
    taps = tuple(float(t) for t in taps)
    th = K._bf(_band_matrix(h, taps, x.device))
    tw = K._bf(_band_matrix(w, taps, x.device))
    y = K._bf(torch.matmul(x.float().reshape(-1, h), th))
    y = y.reshape(b, l, w, h).transpose(2, 3).reshape(-1, w)
    return torch.matmul(y, tw).to(torch.bfloat16).reshape(b, l, h, w)


def gaussian_message(Q_img: torch.Tensor, sigma: float, norm=None
                     ) -> torch.Tensor:
    """Normalized spatial-Gaussian message with self excluded.
    Q_img: (H, W, L) f32 -> (H, W, L)."""
    taps = _gauss_taps(sigma)
    if norm is None:
        norm = gaussian_norm(Q_img.shape[:2], sigma, Q_img.device)
    nq = Q_img * norm
    return (_sep_conv_hw(nq, taps) - nq) * norm


def gaussian_norm(hw, sigma: float, device=None) -> torch.Tensor:
    """(H, W, 1) f32 spatial normalization 1/sqrt(ksum - 1), self excluded;
    the two band products run in f32 with TF32 off, as the JAX package runs
    them at HIGHEST precision."""
    ones = torch.ones(tuple(hw) + (1,), dtype=torch.float32, device=device)
    ksum = _sep_conv_hw(ones, _gauss_taps(sigma)) - 1.0
    return torch.rsqrt(torch.clamp(ksum, min=1e-20))


# ------------------------------------------------------- bilateral grid ----

def _blur_taps(step: float = 1.0) -> np.ndarray:
    """Gaussian taps at integer grid offsets, grid step ``step`` sigmas."""
    radius = max(1, int(math.ceil(2.2 / step)))
    d = np.arange(-radius, radius + 1, dtype=np.float64)
    return np.exp(-0.5 * (d * step) ** 2).astype(np.float32)


_LSQ_TAPS_CACHE: dict = {}


def color_band_taps(step: float, mode: str = "gaussian", radius: int = 2,
                    range_sigmas: float = 255.0 / 13.0) -> np.ndarray:
    """Symmetric band taps of the color blur (grid step ``step`` kernel
    sigmas over ``range_sigmas`` sigmas of value range).  ``gaussian``
    samples exp(-0.5 (k step)^2); ``lsq`` and ``nnls`` fit the band that
    best reproduces the Gaussian kernel through the 2-tap hat basis, the
    latter with nonnegative taps (scipy's ``nnls``)."""
    if mode == "gaussian":
        return _blur_taps(step)
    key = (mode, round(float(step), 6), int(radius),
           round(float(range_sigmas), 4))
    if key not in _LSQ_TAPS_CACHE:
        R, h = float(range_sigmas), float(step)
        nc = int(math.floor(R / h)) + 2
        xs = np.linspace(0.0, R, 768)
        c = xs[:, None] / h - np.arange(nc)[None, :]
        P = np.maximum(0.0, 1.0 - np.abs(c))               # hat factors
        K = np.exp(-0.5 * (xs[:, None] - xs[None, :]) ** 2)
        feats = []
        for k in range(radius + 1):
            Bk = np.zeros((nc, nc))
            idx = np.arange(0, nc - k)
            Bk[idx, idx + k] = 1.0
            if k:
                Bk[idx + k, idx] = 1.0
            feats.append(P @ Bk @ P.T)
        A = np.stack([f.ravel() for f in feats], axis=1)
        if mode == "nnls":
            from scipy.optimize import nnls
            t, _ = nnls(A, K.ravel())
        else:
            t, *_ = np.linalg.lstsq(A, K.ravel(), rcond=None)
        taps = np.zeros(2 * radius + 1, np.float32)
        taps[radius] = t[0]
        for k in range(1, radius + 1):
            taps[radius - k] = taps[radius + k] = t[k]
        _LSQ_TAPS_CACHE[key] = taps
    return _LSQ_TAPS_CACHE[key]


def _cfg_color_taps(cfg: CrfConfig) -> np.ndarray:
    return color_band_taps(cfg.color_step, cfg.color_taps,
                           cfg.color_taps_radius, 255.0 / cfg.srgb)


class _CellLayout:
    """Layout transforms between images and cell planes, for a plan that
    sets h, w, ny, nx, cs_y, cs_x, Z, P and stride."""

    def cells_v(self, x: torch.Tensor) -> torch.Tensor:
        """(B, ch, H, W) -> (B*Z, ch, P), zero-padding H/W up to cells."""
        B, ch = x.shape[:2]
        ph, pw = self.ny * self.cs_y - self.h, self.nx * self.cs_x - self.w
        if ph or pw:
            x = torch.nn.functional.pad(x, (0, pw, 0, ph))
        return (x.reshape(B, ch, self.ny, self.cs_y, self.nx, self.cs_x)
                .permute(0, 2, 4, 1, 3, 5)
                .reshape(B * self.Z, ch, self.P).contiguous())

    def uncells_v(self, y: torch.Tensor, ch: int) -> torch.Tensor:
        """(B*Z, ch, P) -> (B, ch, H, W)."""
        B, ny, nx = y.shape[0] // self.Z, self.ny, self.nx
        return (y.reshape(B, ny, nx, ch, self.cs_y, self.cs_x)
                .permute(0, 3, 1, 4, 2, 5)
                .reshape(B, ch, ny * self.cs_y,
                         nx * self.cs_x))[:, :, :self.h, :self.w]

    def uncells_v_wh(self, y: torch.Tensor, ch: int) -> torch.Tensor:
        """(B*Z, ch, P) -> (B, ch, W, H), the orientation the image-layout
        blur takes first."""
        B, ny, nx = y.shape[0] // self.Z, self.ny, self.nx
        return (y.reshape(B, ny, nx, ch, self.cs_y, self.cs_x)
                .permute(0, 3, 2, 5, 1, 4)
                .reshape(B, ch, nx * self.cs_x,
                         ny * self.cs_y))[:, :, :self.w, :self.h]

    def subsample(self, x: torch.Tensor, ch: int) -> torch.Tensor:
        """Every stride-th pixel per axis of each cell, row-major."""
        s = self.stride
        sub = x.reshape(-1, ch, self.cs_y, self.cs_x)[:, :, ::s, ::s]
        return sub.reshape(-1, ch, self.P // (s * s)).contiguous()


class CellPlan(_CellLayout):
    """Cell geometry of an (h, w) image for the plane engine (the JAX
    package's ``_PallasPlan``, without its TPU tile padding), for any batch:
    the batch size is read from the planes' shapes.

    Cells are anisotropic: for sxy >= 80 the x width snaps to 128 and the y
    height to the largest divisor of h within [sxy/2, sxy].  ``S`` (Z, Z)
    is the cross-cell spatial blur; ``bb_taps`` the color band, which the
    kernels module turns into the joint (r, g) blur (the JAX ``Brg``) and
    the b-axis band."""

    def __init__(self, h: int, w: int, sxy: float, srgb: float,
                 color_step: float, splat_stride: int = 1, ctaps=None,
                 device=None):
        ctaps = ctaps if ctaps is not None else _blur_taps(color_step)
        self.h, self.w = h, w
        self.device = torch.device("cpu" if device is None else device)
        cs = max(int(round(sxy)), 1)
        self.cs_y = cs
        for d in range(cs, max(cs // 2, 1) - 1, -1):
            if h % d == 0:
                self.cs_y = d
                break
        self.cs_x = 128 if cs >= 80 else cs
        srgb_grid = srgb * color_step
        self.nc = int(math.floor(255.0 / srgb_grid)) + 2
        self.inv_step = 1.0 / srgb_grid
        self.ny, self.nx = -(-h // self.cs_y), -(-w // self.cs_x)
        self.Z = self.ny * self.nx
        self.P = self.cs_y * self.cs_x
        self.stride = (splat_stride
                       if splat_stride > 1 and self.cs_y % splat_stride == 0
                       and self.cs_x % splat_stride == 0 else 1)
        self.S = torch.from_numpy(np.kron(
            band_matrix_np(self.ny, _blur_taps(self.cs_y / sxy)),
            band_matrix_np(self.nx, _blur_taps(self.cs_x / sxy)))).to(
                self.device)
        self.bb_taps = tuple(float(t) for t in np.asarray(ctaps, np.float32))

    def z_blur(self, G: torch.Tensor) -> torch.Tensor:
        """Cross-cell spatial blur of the grids (B*Z, D, C): a batched
        (Z, Z) product in f32.  A bf16 grid is multiplied with the
        bf16-rounded S and rounded back, as the JAX package does."""
        BZ, D, C = G.shape
        S = self.S.to(G.dtype).float()
        out = torch.matmul(S.t(), G.float().reshape(BZ // self.Z, self.Z,
                                                     D * C))
        return out.to(G.dtype).reshape(BZ, D, C)


@functools.lru_cache(maxsize=16)
def cell_plan(h: int, w: int, cfg: CrfConfig, device) -> CellPlan:
    """The plan of (h, w) images at ``cfg`` with its (Z, 1, P) spatial
    normalization planes ``gn`` (one image position each, shared by the
    batch), built once for every batch size: the matrices are copied to the
    device, and a copy from pageable host memory waits for the device to
    drain.  A traced program (``export.py``) holds them as constants."""
    plan = CellPlan(h, w, cfg.sxy_bilateral, cfg.srgb, cfg.color_step,
                    cfg.splat_stride, ctaps=_cfg_color_taps(cfg),
                    device=device)
    gn = gaussian_norm((h, w), cfg.sxy_gaussian, plan.device)
    plan.gn = plan.cells_v(gn.permute(2, 0, 1)[None])
    return plan


class BilateralPlan(_CellLayout):
    """The XLA engine's bilateral filter for one (h, w) image (the JAX
    package's ``_BilateralPlan``): square cells of ``cs = round(sxy)`` px,
    the image zero-padded to whole cells; the cross-cell blur ``S`` is the
    kron of two band matrices at grid step 1.0 (not ``CellPlan``'s
    ``cs / sxy``); the color blur takes the band ``ctaps``.  A splat stride
    that does not divide ``cs`` falls back to 1.  Built once per image and
    shared by the norm pass and every iteration."""

    def __init__(self, im: torch.Tensor, sxy: float, srgb: float,
                 color_step: float, splat_stride: int = 1, ctaps=None):
        ctaps = ctaps if ctaps is not None else _blur_taps(color_step)
        h, w, _ = im.shape
        self.h, self.w = h, w
        self.cs_y = self.cs_x = cs = max(int(round(sxy)), 1)
        self.stride = (splat_stride
                       if splat_stride > 1 and cs % splat_stride == 0 else 1)
        srgb_grid = srgb * color_step
        self.nc = int(math.floor(255.0 / srgb_grid)) + 2
        self.inv_step = 1.0 / srgb_grid
        self.ny, self.nx = -(-h // cs), -(-w // cs)
        self.Z, self.P = self.ny * self.nx, cs * cs
        self.ctaps = tuple(float(t) for t in np.asarray(ctaps, np.float32))
        self.S = _kron_band(self.ny, self.nx, im.device)           # (Z, Z)
        self.rgb = self.cells_v(im.to(torch.float32).permute(2, 0, 1)[None])
        self.rgb_sub = (self.subsample(self.rgb, 3) if self.stride > 1
                        else self.rgb)

    def apply_planes(self, V: torch.Tensor) -> torch.Tensor:
        """Bilateral filter of cell planes (Z, L, P) f32 -> (Z, L, P) f32,
        self-contribution included: the f32 splat (of every stride-th pixel,
        x stride^2), the cross-cell blur in f32, the color blur and slice."""
        L = V.shape[1]
        s = self.stride
        geo = dict(nc=self.nc, inv_step=self.inv_step)
        if s > 1:
            G = K.splat_planes(self.rgb_sub, self.subsample(V, L), L=L,
                               out_dtype=torch.float32, **geo) * float(s * s)
        else:
            G = K.splat_planes(self.rgb, V, L=L, out_dtype=torch.float32,
                               **geo)
        Z, D, C = G.shape
        G = torch.matmul(self.S.t(), G.reshape(Z, D * C)).reshape(Z, D, C)
        return K.slice_planes(self.rgb, G, L=L, ctaps=self.ctaps, **geo)

    def apply(self, values: torch.Tensor) -> torch.Tensor:
        """values (N, L) f32 -> filtered (N, L), self included."""
        L = values.shape[1]
        V = self.cells_v(values.reshape(self.h, self.w, L).permute(2, 0, 1)
                         [None])
        out = self.uncells_v(self.apply_planes(V), L)[0]
        return out.permute(1, 2, 0).reshape(self.h * self.w, L)


@functools.lru_cache(maxsize=16)
def _kron_band(ny: int, nx: int, device) -> torch.Tensor:
    taps = _blur_taps(1.0)
    return torch.from_numpy(np.kron(band_matrix_np(ny, taps),
                                    band_matrix_np(nx, taps))).to(device)


def bilateral_filter(im: torch.Tensor, values: torch.Tensor, sxy: float,
                     srgb: float, color_step: float = 1.0) -> torch.Tensor:
    """Approximate K @ values for the bilateral kernel, self-contribution
    included (see :func:`bilateral_self_weight`).  im (H, W, 3) 0-255;
    values (N, L) f32."""
    return BilateralPlan(im, sxy, srgb, color_step).apply(values)


def bilateral_self_weight(im: torch.Tensor, sxy: float, srgb: float,
                          color_step: float = 1.0, ctaps=None
                          ) -> torch.Tensor:
    """Closed-form per-pixel self-weight (N,) of the cell splat, blur and
    slice: 1 from the cell's centre blur tap, and per color dim
    (s0^2 + s1^2) B(0) + 2 s0 s1 B(1)."""
    coords = (im.to(torch.float32) / (srgb * color_step)).reshape(-1, 3)
    frac = coords - torch.floor(coords)
    s0, s1 = 1.0 - frac, frac
    taps = ctaps if ctaps is not None else _blur_taps(color_step)
    b0, b1 = float(taps[len(taps) // 2]), float(taps[len(taps) // 2 + 1])
    per_dim = (s0 * s0 + s1 * s1) * b0 + 2.0 * s0 * s1 * b1
    return torch.prod(per_dim, dim=1)


def bilateral_norm(im: torch.Tensor, sxy: float, srgb: float,
                   color_step: float = 1.0):
    """(norm, w_self), each (N, 1): norm = 1/sqrt(K 1 - w_self)."""
    n = im.shape[0] * im.shape[1]
    w_self = bilateral_self_weight(im, sxy, srgb, color_step)[:, None]
    ones = torch.ones((n, 1), dtype=torch.float32, device=im.device)
    ksum = bilateral_filter(im, ones, sxy, srgb, color_step) - w_self
    return torch.rsqrt(torch.clamp(ksum, min=1e-20)), w_self


def bilateral_message(im: torch.Tensor, Q: torch.Tensor, sxy: float,
                      srgb: float, norm=None, w_self=None,
                      color_step: float = 1.0) -> torch.Tensor:
    """Normalized bilateral message with self excluded.  Q: (N, L)."""
    if norm is None:
        norm, w_self = bilateral_norm(im, sxy, srgb, color_step)
    nq = Q * norm
    return (bilateral_filter(im, nq, sxy, srgb, color_step)
            - w_self * nq) * norm


def _at_scale(cfg: CrfConfig) -> CrfConfig:
    """The configuration that ``resolution_scale`` s runs at 1/s
    resolution: both spatial widths divided by s."""
    s = cfg.resolution_scale
    return dataclasses.replace(cfg, resolution_scale=1,
                               sxy_gaussian=cfg.sxy_gaussian / s,
                               sxy_bilateral=cfg.sxy_bilateral / s)


def _upsample(x: torch.Tensor, s: int, h: int, w: int, dim: int):
    """Repeat each pixel s times along ``dim`` and ``dim + 1``, cropped to
    (h, w)."""
    x = x.repeat_interleave(s, dim).repeat_interleave(s, dim + 1)
    return x.narrow(dim, 0, h).narrow(dim + 1, 0, w)


def _mean_field_planes(plan: CellPlan, cfg: CrfConfig, n_labels: int,
                       rgb: torch.Tensor, labels_c: torch.Tensor,
                       unary_c: torch.Tensor = None) -> torch.Tensor:
    """Mean field over (B*Z, ., P) planes from hard labels ``labels_c``
    (B*Z, 1, P) int32 (the two-level unary, rebuilt in the step kernel), or
    from the caller's energies ``unary_c`` (B*Z, L, P) f32 with zero
    labels; ``rgb`` (B*Z, 3, P) f32 0-255; ``plan`` from :func:`cell_plan`.
    Returns Q (B*Z, L, P) bf16.  The Q state, messages and the unary stream
    are bf16; every kernel computes in f32.  Spans: ``crf.norm`` (the norm
    pass and the attribute slice), then per iteration ``crf.blur``,
    ``crf.splat`` and ``crf.step``."""
    L = n_labels
    B = rgb.shape[0] // plan.Z
    if unary_c is None:
        n_energy = -math.log((1.0 - cfg.gt_prob) / (n_labels - 1))
        p_energy = -math.log(cfg.gt_prob)
    else:
        n_energy = p_energy = 0.0
    dev = rgb.device
    taps = tuple(float(t) for t in _gauss_taps(cfg.sxy_gaussian))
    gn_small = plan.gn                                           # (Z, 1, P)
    # the spatial message on the cell planes where the radius fits in a
    # cell and the cells are 128 px wide; else in image layout (JAX
    # _mean_field_planes), from A = bf16(Q * bf16(gn))
    on_planes = (len(taps) // 2 <= min(plan.cs_y, plan.cs_x)
                 and plan.cs_x % 128 == 0)
    gn_bf = None if on_planes else gn_small.repeat(B, 1, 1).to(
        torch.bfloat16)

    def spatial(Q):
        if on_planes:
            return K.gaussian_blur_planes(
                Q, gn_small, taps=taps, B=B, ny=plan.ny, nx=plan.nx,
                cs_y=plan.cs_y, cs_x=plan.cs_x)
        return plan.cells_v(_sep_conv_bwh_to_bhw(
            plan.uncells_v_wh(Q * gn_bf, L), taps))

    geo = dict(nc=plan.nc, inv_step=plan.inv_step)
    s = plan.stride

    # norm pass: splat the valid mask (f32 grid: the rsqrt(ksum - b_self)
    # cancellation needs it), cross-cell blur, then one kernel slices it
    # and emits the packed attrs planes, Q0 and their subsampled copies
    with annotate("crf.norm"):
        valid = plan.cells_v(torch.ones((B, 1, plan.h, plan.w),
                                        dtype=torch.float32, device=dev))
        if s > 1:
            Gn = K.splat_planes(plan.subsample(rgb, 3),
                                plan.subsample(valid, 1), L=1,
                                out_dtype=torch.float32, **geo)
            Gn = Gn * float(s * s)
        else:
            Gn = K.splat_planes(rgb, valid, L=1, out_dtype=torch.float32,
                                **geo)
        Gn = plan.z_blur(Gn)
        outs = K.slice_attrs_planes(
            rgb, Gn, gn_small, labels_c, L=L, ctaps=plan.bb_taps, stride=s,
            cs_y=plan.cs_y, cs_x=plan.cs_x, h=plan.h, w=plan.w, nx=plan.nx,
            Z=plan.Z, gt_prob=float(cfg.gt_prob), **geo)
        attrs, Q = outs[0], outs[1]
        attrs_sub, Q_sub = (outs[2], outs[3]) if s > 1 else (attrs, None)
        unary_b = None
        if unary_c is not None:
            # Q0 = softmax(-U) in f32, stored bf16, in place of the closed
            # form
            Q = torch.softmax(-unary_c.float(), dim=1).to(torch.bfloat16)
            Q_sub = plan.subsample(Q, L) if s > 1 else None
            unary_b = unary_c.to(torch.bfloat16).contiguous()

    # each iteration's spans: the spatial message, the splat of Q onto the
    # bilateral grid with the grid's cross-cell blur, and the step
    for i in range(cfg.n_iters):
        last = i == cfg.n_iters - 1
        with annotate("crf.blur"):
            f_gauss = spatial(Q)
        with annotate("crf.splat"):
            G = K.splat_planes(attrs_sub, Q_sub if s > 1 else Q, L=L,
                               out_dtype=torch.bfloat16, **geo)
            G = plan.z_blur(G)
        with annotate("crf.step"):
            out = K.mf_step_planes(
                attrs, G, f_gauss, Q, unary_b, L=L, ctaps=plan.bb_taps,
                cg=float(cfg.compat_gaussian),
                cb=float(cfg.compat_bilateral),
                n_energy=n_energy, p_energy=p_energy,
                sub_stride=1 if last else s, cs_y=plan.cs_y, cs_x=plan.cs_x,
                **geo)
        Q, Q_sub = (out[0], None) if len(out) == 1 else out
    return Q


@functools.lru_cache(maxsize=16)
def _gaussian_norm_img(h: int, w: int, sigma: float, device) -> torch.Tensor:
    with core.precision_flags(core.Policy(torch.float32)):
        return gaussian_norm((h, w), sigma, device)


def _mean_field_xla(im: torch.Tensor, unary: torch.Tensor, cfg: CrfConfig,
                    n_labels: int) -> torch.Tensor:
    """The XLA engine's mean field of one image (JAX ``mean_field`` off the
    plane engine): f32 Q (N, L), the spatial message in image layout, the
    bilateral one through :class:`BilateralPlan`, whose norm is floored at
    the self-weight when the splat is subsampled."""
    h, w, _ = im.shape
    L = n_labels
    ctaps = _cfg_color_taps(cfg)
    g_norm = _gaussian_norm_img(h, w, float(cfg.sxy_gaussian), im.device)
    plan = BilateralPlan(im, cfg.sxy_bilateral, cfg.srgb, cfg.color_step,
                         cfg.splat_stride, ctaps=ctaps)
    b_self = bilateral_self_weight(im, cfg.sxy_bilateral, cfg.srgb,
                                   cfg.color_step, ctaps=ctaps)[:, None]
    ones = torch.ones((h * w, 1), dtype=torch.float32, device=im.device)
    ksum = plan.apply(ones) - b_self
    floor = b_self if plan.stride > 1 else torch.full_like(b_self, 1e-20)
    b_norm = torch.rsqrt(torch.maximum(ksum, floor))
    Q = torch.softmax(-unary, dim=-1)
    for _ in range(cfg.n_iters):
        msg_g = gaussian_message(Q.reshape(h, w, L), cfg.sxy_gaussian,
                                 norm=g_norm).reshape(-1, L)
        nq = Q * b_norm
        msg_b = torch.clamp(plan.apply(nq) - b_self * nq, min=0.0) * b_norm
        logits = (-unary + cfg.compat_gaussian * msg_g
                  + cfg.compat_bilateral * msg_b)
        Q = torch.softmax(logits, dim=-1)
    return Q


@torch.inference_mode()
def mean_field(im: torch.Tensor, unary: torch.Tensor, cfg: CrfConfig,
               n_labels: int) -> torch.Tensor:
    """im (H, W, 3) 0-255; unary (N, L) energies.  Returns Q (N, L) f32 on
    the device of ``im``: the kernels on a CUDA tensor, their plain
    versions on a CPU tensor.  ``backend="xla"`` runs the XLA engine,
    ``"auto"`` and ``"pallas"`` the plane engine with the explicit-unary
    step.  ``resolution_scale`` s > 1 runs on every s-th pixel per axis and
    repeats Q back (JAX ``mean_field``)."""
    h, w, _ = im.shape
    dev = im.device
    unary = unary.to(dev, torch.float32)
    s = cfg.resolution_scale
    if s > 1:
        u_s = unary.reshape(h, w, n_labels)[::s, ::s]
        hs, ws = u_s.shape[:2]
        Q = mean_field(im[::s, ::s].contiguous(),
                       u_s.reshape(hs * ws, n_labels), _at_scale(cfg),
                       n_labels)
        Q = _upsample(Q.reshape(hs, ws, n_labels), s, h, w, 0)
        return Q.reshape(h * w, n_labels)
    with core.precision_flags(core.Policy(torch.float32)):
        if cfg.backend == "xla":
            return _mean_field_xla(im.to(torch.float32), unary, cfg,
                                   n_labels)
        plan = cell_plan(h, w, cfg, dev)
        rgb = plan.cells_v(im.to(torch.float32).permute(2, 0, 1)[None])
        u_c = plan.cells_v(unary.reshape(h, w, n_labels).permute(2, 0, 1)
                           [None])
        zeros = torch.zeros((plan.Z, 1, plan.P), dtype=torch.int32,
                            device=dev)
        Q = _mean_field_planes(plan, cfg, n_labels, rgb, zeros, unary_c=u_c)
        q_img = plan.uncells_v(Q.float(), n_labels)[0]          # (L, H, W)
        return q_img.permute(1, 2, 0).reshape(h * w, n_labels)


def do_crf(im, mask, zero_unsure: bool = True, cfg: CrfConfig = CrfConfig(),
           device=None):
    """Reference utils.py:74-91 API: hard mask in and out, with label
    compression (``np.unique`` on the host), the single-label no-op and the
    reference's remap (off by one under ``zero_unsure``).  ``im`` (H, W, 3)
    0-255 and ``mask`` (H, W) int, numpy; the mean field runs on ``device``
    (the card unless the caller asks for the CPU)."""
    im = np.asarray(im)
    mask = np.asarray(mask)
    colors, labels = np.unique(mask, return_inverse=True)
    n_labels = len(colors)
    if n_labels == 1:
        return mask.copy()
    dev = core.resolve_device(device)
    U = unary_from_labels(torch.from_numpy(labels.reshape(-1)).to(dev),
                          n_labels, cfg.gt_prob, zero_unsure=zero_unsure)
    Q = mean_field(torch.from_numpy(np.asarray(im, np.float32)).to(dev), U,
                   cfg, n_labels)
    MAP = torch.argmax(Q, dim=-1).cpu().numpy().reshape(mask.shape[:2])
    return colors[MAP]


@torch.inference_mode()
def mean_field_batched(imgs: torch.Tensor, masks: torch.Tensor,
                       cfg: CrfConfig = CrfConfig(), n_labels: int = 21
                       ) -> torch.Tensor:
    """Batched CRF over hard masks (all ``n_labels`` classes, no label
    compression).  imgs (B, H, W, 3) 0-255; masks (B, H, W) int.  Returns
    the refined (B, H, W) int32 masks on the device of ``imgs``: the
    kernels on a CUDA tensor, their plain versions on a CPU tensor.  The
    plane engine takes the batch at once; the XLA engine (``backend="xla"``)
    one image at a time, each through :func:`mean_field`.  With
    ``resolution_scale`` s > 1 either engine refines every s-th pixel per
    axis and repeats the masks back (JAX ``mean_field_batched``)."""
    B, H, W = masks.shape
    dev = imgs.device
    s = cfg.resolution_scale
    if s > 1:
        out = mean_field_batched(imgs[:, ::s, ::s].contiguous(),
                                 masks[:, ::s, ::s].contiguous(),
                                 _at_scale(cfg), n_labels)
        return _upsample(out, s, H, W, 1).contiguous()
    if cfg.backend == "xla":
        out = []
        for im, mask in zip(imgs, masks):
            U = unary_from_labels(mask.reshape(-1).to(dev), n_labels,
                                  cfg.gt_prob, zero_unsure=False)
            Q = mean_field(im, U, cfg, n_labels)
            out.append(torch.argmax(Q, dim=-1).reshape(H, W))
        return torch.stack(out).to(torch.int32)
    plan = cell_plan(H, W, cfg, dev)
    # f32 products without TF32: the norm grid's cross-cell blur is the
    # cancellation-sensitive one
    with core.precision_flags(core.Policy(torch.float32)):
        rgb = plan.cells_v(imgs.to(torch.float32).permute(0, 3, 1, 2))
        labels_c = plan.cells_v(masks[:, None].to(dev, torch.int32))
        Q = _mean_field_planes(plan, cfg, n_labels, rgb, labels_c)
        pred = torch.argmax(Q.float(), dim=1, keepdim=True)
    return plan.uncells_v(pred, 1)[:, 0].to(torch.int32)
