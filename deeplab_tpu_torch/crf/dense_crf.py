"""Fully-connected CRF mean field in cell-plane layout
(deeplab_tpu/crf/dense_crf.py, its plane engine).

The mean field of Krähenbühl & Koltun (Algorithm 1) with the reference's
pydensecrf parameters (utils.py:74-91): a two-level unary from hard labels,
a truncated separable spatial Gaussian and a bilateral-grid bilateral
kernel, symmetric normalization, self-interaction excluded.  Everything
lives in pixel-major *cell planes* ``(B*Z, ch, P)``: the image is cut into
``cs_y x cs_x`` cells (Z per image, P pixels each); the bilateral grid of a
cell is ``(D, C)`` with ``d = b*L + l`` and ``c = r*nc + g``.

Per request the plane engine runs four hand-written kernels
(``kernels/crf_fused.py``): ``splat_planes`` (the norm pass and once per
iteration), ``slice_attrs_planes`` (once), ``gaussian_blur_planes`` and
``mf_step_planes`` (once per iteration).  The cross-cell grid blur
``CellPlan.z_blur`` is a plain batched Z x Z product.

Ported: the labels path of ``mean_field_batched``.  Not yet:
``resolution_scale > 1``, the XLA engine (``backend="xla"``), geometries
where the JAX package's fused spatial blur does not engage, and the
explicit-unary ``mean_field``/``do_crf``; each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from deeplab_tpu_torch import core
from deeplab_tpu_torch.kernels import crf_fused as K
from deeplab_tpu_torch.kernels.crf_fused import band_matrix_np


@dataclasses.dataclass(frozen=True)
class CrfConfig:
    """Same fields and defaults as the JAX ``CrfConfig``.  ``backend``:
    ``"auto"`` and ``"pallas"`` run the port's plane engine; ``"xla"`` is
    not ported."""
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
    # run at 1/s resolution and upsample (not ported)
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
        U = torch.where((labels == 0)[:, None],
                        torch.tensor(-math.log(1.0 / n_labels)), U)
    return U


# ------------------------------------------------------ spatial Gaussian ----

def _gauss_taps(sigma: float) -> np.ndarray:
    radius = int(math.ceil(2.5 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    return np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)


def gaussian_norm(hw, sigma: float, device=None) -> torch.Tensor:
    """(H, W, 1) f32 spatial normalization 1/sqrt(ksum - 1), self excluded;
    the two band products run in f32 with TF32 off, as the JAX package runs
    them at HIGHEST precision."""
    taps = _gauss_taps(sigma)
    h, w = hw
    th = torch.from_numpy(band_matrix_np(h, taps)).to(device)
    tw = torch.from_numpy(band_matrix_np(w, taps)).to(device)
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    ksum = (th @ ones) @ tw.t() - 1.0
    return torch.rsqrt(torch.clamp(ksum, min=1e-20))[:, :, None]


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


class CellPlan:
    """Cell geometry of a (B, h, w) batch for the plane engine (the JAX
    package's ``_PallasPlan``, without its TPU tile padding).

    Cells are anisotropic: for sxy >= 80 the x width snaps to 128 and the y
    height to the largest divisor of h within [sxy/2, sxy].  ``S`` (Z, Z)
    is the cross-cell spatial blur; ``bb_taps`` the color band, which the
    kernels module turns into the joint (r, g) blur (the JAX ``Brg``) and
    the b-axis band."""

    def __init__(self, B: int, h: int, w: int, sxy: float, srgb: float,
                 color_step: float, splat_stride: int = 1, ctaps=None,
                 device=None):
        ctaps = ctaps if ctaps is not None else _blur_taps(color_step)
        self.B, self.h, self.w = B, h, w
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

    # ---- layout transforms: (B, ch, H, W) <-> (B*Z, ch, P) ----

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

    def subsample(self, x: torch.Tensor, ch: int) -> torch.Tensor:
        """Every stride-th pixel per axis of each cell, row-major."""
        s = self.stride
        sub = x.reshape(-1, ch, self.cs_y, self.cs_x)[:, :, ::s, ::s]
        return sub.reshape(-1, ch, self.P // (s * s)).contiguous()

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
def cell_plan(B: int, h: int, w: int, cfg: CrfConfig, device) -> CellPlan:
    """The plan of a (B, h, w) batch at ``cfg`` with its (Z, 1, P) spatial
    normalization planes ``gn`` (one image position each, shared by the
    batch), built once: the matrices are copied to the device, and a copy
    from pageable host memory waits for the device to drain."""
    plan = CellPlan(B, h, w, cfg.sxy_bilateral, cfg.srgb, cfg.color_step,
                    cfg.splat_stride, ctaps=_cfg_color_taps(cfg),
                    device=device)
    gn = gaussian_norm((h, w), cfg.sxy_gaussian, plan.device)
    plan.gn = plan.cells_v(gn.permute(2, 0, 1)[None])
    return plan


def check_supported(cfg: CrfConfig, hw) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.backend == "xla":
        raise NotImplementedError(
            "the XLA CRF engine is not ported; backend 'auto' or 'pallas' "
            "runs the plane engine")
    if cfg.resolution_scale != 1:
        raise NotImplementedError("CrfConfig.resolution_scale > 1 is not "
                                  "ported yet")
    h, w = hw
    plan = CellPlan(1, h, w, cfg.sxy_bilateral, cfg.srgb, cfg.color_step,
                    cfg.splat_stride, ctaps=np.ones(1, np.float32))
    r = len(_gauss_taps(cfg.sxy_gaussian)) // 2
    if not (r <= min(plan.cs_y, plan.cs_x) and plan.cs_x % 128 == 0
            and r <= 16 and plan.cs_y % 16 == 0):
        raise NotImplementedError(
            f"cell geometry {plan.cs_y}x{plan.cs_x} (sxy_bilateral "
            f"{cfg.sxy_bilateral}, image {h}x{w}) needs the spatial blur "
            f"fallback, which is not ported yet")


def _mean_field_planes(plan: CellPlan, cfg: CrfConfig, n_labels: int,
                       rgb: torch.Tensor, labels_c: torch.Tensor
                       ) -> torch.Tensor:
    """Mean field over (B*Z, ., P) planes from hard labels ``labels_c``
    (B*Z, 1, P) int32; ``rgb`` (B*Z, 3, P) f32 0-255; ``plan`` from
    :func:`cell_plan`.  Returns Q (B*Z, L, P)
    bf16.  The Q state and messages are bf16; every kernel computes in f32."""
    L = n_labels
    n_energy = -math.log((1.0 - cfg.gt_prob) / (n_labels - 1))
    p_energy = -math.log(cfg.gt_prob)
    dev = rgb.device
    taps = tuple(float(t) for t in _gauss_taps(cfg.sxy_gaussian))
    gn_small = plan.gn                                           # (Z, 1, P)
    valid = plan.cells_v(torch.ones((plan.B, 1, plan.h, plan.w),
                                    dtype=torch.float32, device=dev))
    geo = dict(nc=plan.nc, inv_step=plan.inv_step)
    s = plan.stride

    # norm pass: splat the valid mask (f32 grid: the rsqrt(ksum - b_self)
    # cancellation needs it), cross-cell blur, then one kernel slices it
    # and emits the packed attrs planes, Q0 and their subsampled copies
    if s > 1:
        Gn = K.splat_planes(plan.subsample(rgb, 3), plan.subsample(valid, 1),
                            L=1, out_dtype=torch.float32, **geo)
        Gn = Gn * float(s * s)
    else:
        Gn = K.splat_planes(rgb, valid, L=1, out_dtype=torch.float32, **geo)
    Gn = plan.z_blur(Gn)
    outs = K.slice_attrs_planes(
        rgb, Gn, gn_small, labels_c, L=L, ctaps=plan.bb_taps, stride=s,
        cs_y=plan.cs_y, cs_x=plan.cs_x, h=plan.h, w=plan.w, nx=plan.nx,
        Z=plan.Z, gt_prob=float(cfg.gt_prob), **geo)
    attrs, Q = outs[0], outs[1]
    attrs_sub, Q_sub = (outs[2], outs[3]) if s > 1 else (attrs, None)

    for i in range(cfg.n_iters):
        last = i == cfg.n_iters - 1
        f_gauss = K.gaussian_blur_planes(
            Q, gn_small, taps=taps, B=plan.B, ny=plan.ny, nx=plan.nx,
            cs_y=plan.cs_y, cs_x=plan.cs_x)
        G = K.splat_planes(attrs_sub, Q_sub if s > 1 else Q, L=L,
                           out_dtype=torch.bfloat16, **geo)
        G = plan.z_blur(G)
        out = K.mf_step_planes(
            attrs, G, f_gauss, Q, L=L, ctaps=plan.bb_taps,
            cg=float(cfg.compat_gaussian), cb=float(cfg.compat_bilateral),
            n_energy=n_energy, p_energy=p_energy,
            sub_stride=1 if last else s, cs_y=plan.cs_y, cs_x=plan.cs_x,
            **geo)
        Q, Q_sub = (out[0], None) if len(out) == 1 else out
    return Q


@torch.inference_mode()
def mean_field_batched(imgs: torch.Tensor, masks: torch.Tensor,
                       cfg: CrfConfig = CrfConfig(), n_labels: int = 21
                       ) -> torch.Tensor:
    """Batched CRF over hard masks (all ``n_labels`` classes, no label
    compression).  imgs (B, H, W, 3) 0-255; masks (B, H, W) int.  Returns
    the refined (B, H, W) int32 masks on the device of ``imgs``: the
    kernels on a CUDA tensor, their plain versions on a CPU tensor."""
    B, H, W = masks.shape
    check_supported(cfg, (H, W))
    dev = imgs.device
    plan = cell_plan(B, H, W, cfg, dev)
    # f32 products without TF32: the norm grid's cross-cell blur is the
    # cancellation-sensitive one
    with core.precision_flags(core.Policy(torch.float32)):
        rgb = plan.cells_v(imgs.to(torch.float32).permute(0, 3, 1, 2))
        labels_c = plan.cells_v(masks[:, None].to(dev, torch.int32))
        Q = _mean_field_planes(plan, cfg, n_labels, rgb, labels_c)
        pred = torch.argmax(Q.float(), dim=1, keepdim=True)
    return plan.uncells_v(pred, 1)[:, 0].to(torch.int32)
