"""The dense CRF's four kernels on cell planes: splat, norm-pass slice,
spatial blur and mean-field step, each beside its plain PyTorch version.

Replaces the TPU kernels of ``deeplab_tpu/kernels/crf_fused.py``:

- ``splat_planes`` (its ``pl.pallas_call`` at line 702),
- ``slice_attrs_planes`` (line 890),
- ``gaussian_blur_planes`` (line 568, the fused row kernel),
- ``mf_step_planes`` (line 988).

The CUDA source is ``csrc/crf_fused.cu``; its header says what bounds each
kernel on the H100 and how the design deals with it.  The TPU forms the
splat and the slice as dense products against hat-factor matrices; a pixel
touches only 2 bins per color channel, so the CUDA kernels scatter and
gather the 8 grid corners of each pixel instead.  The plain versions here
(``*_reference``) keep the dense formulation: f32 products of the same
bf16-rounded operands, so a kernel and its plain version differ only in
summation order.  A CPU tensor runs the plain version; a CUDA tensor runs
the kernel or raises.

Layouts (the TPU's tile padding of the grid is dropped): rgb planes
(Z, 3, P) f32 0-255; packed attrs (Z, 8, P) f32 (``ATTR_*`` rows); values
and Q (Z, L, P); grids (Z, D, C) with D = nc*L (d = b*L + l) and C = nc^2
(c = r*nc + g).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

# Packed per-pixel attribute rows of the (Z, 8, P) f32 attrs planes.
ATTR_RGB = 0      # rows 0-2: r, g, b in 0-255
ATTR_GN = 3       # spatial-Gaussian normalization 1/sqrt(ksum)
ATTR_BN = 4       # bilateral normalization 1/sqrt(ksum)
ATTR_BSELF = 5    # bilateral self-weight
ATTR_LABEL = 6    # hard label (exact small ints in f32)
ATTR_BSCALE = 7   # splat-side scale: b_norm * valid * stride^2
ATTR_ROWS = 8

KERNELS = ("splat_planes", "slice_attrs_planes", "gaussian_blur_planes",
           "mf_step_planes")

# A kernel against its plain version on the same inputs, relative to the
# largest value of each output (of each attrs row): both take the same
# bf16-rounded operands, whose products are exact in f32, and differ in
# summation order.  f32 outputs 1e-4; bf16 outputs, and the b_norm/b_scale
# rows sliced from a bf16-rounded grid, 2 bf16 ulps (one rounding may
# flip); the step's Q 4 ulps (a flipped grid rounding moves a logit by
# cb * b_norm * 2^-8 of the slice).
PLAIN_F32_REL, PLAIN_BF16_REL, PLAIN_STEP_REL = 1e-4, 2.0 ** -7, 2.0 ** -6

MAX_COLOR_TAPS = 7    # color band radius <= 3
MAX_SPATIAL_TAPS = 33  # spatial radius <= 16
_CHUNK_BYTES = 1 << 28  # plain versions: working set per chunk of cells

_BF16 = torch.bfloat16
_F32 = torch.float32


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32."""
    return x.to(_BF16).to(_F32)


def _hat(coord: torch.Tensor, nbins: int) -> torch.Tensor:
    """(Z, P) grid coordinates -> (Z, nbins, P) hat weights
    max(1 - |bin - coord|, 0), as the TPU kernels build them."""
    bins = torch.arange(nbins, dtype=_F32, device=coord.device)[:, None]
    return torch.clamp(1.0 - (bins - coord[:, None]).abs(), min=0.0)


def _t_rg(coords: torch.Tensor, nc: int) -> torch.Tensor:
    """(Z, 3, P) coordinates -> (Z, C, P) bf16-rounded joint (r, g) hat
    factor, c = r*nc + g."""
    Z, _, P = coords.shape
    hr, hg = _hat(coords[:, 0], nc), _hat(coords[:, 1], nc)
    return _bf(hr[:, :, None] * hg[:, None]).reshape(Z, nc * nc, P)


def _cell_chunks(Z: int, per_cell_bytes: int):
    n = max(1, _CHUNK_BYTES // max(per_cell_bytes, 1))
    return [slice(i, min(Z, i + n)) for i in range(0, Z, n)]


def band_matrix_np(n: int, taps) -> np.ndarray:
    """(n, n) f32 banded matrix: ``taps`` (odd count) on the diagonals at
    offsets -R..R, m[i, i + k] = taps[R + k]."""
    radius = len(taps) // 2
    m = np.zeros((n, n), np.float32)
    for offset, wgt in zip(range(-radius, radius + 1), taps):
        diag = np.arange(max(0, -offset), min(n, n - offset))
        m[diag, diag + offset] = wgt
    return m


@functools.lru_cache(maxsize=16)
def _brg_bf16_np(nc: int, ctaps: tuple) -> np.ndarray:
    band = band_matrix_np(nc, np.asarray(ctaps, np.float32))
    return _bf(torch.from_numpy(np.kron(band, band))).numpy()


def _brg_bf16(nc: int, ctaps, device) -> torch.Tensor:
    """The joint (r, g) color blur (C, C) as the TPU multiplies by it: the
    kron of the two band matrices in f32, rounded to bf16.  The kernels take
    the same weights as a stencil (:func:`_color_taps_host`)."""
    return torch.from_numpy(_brg_bf16_np(nc, tuple(ctaps))).to(device)


# ------------------------------------------------------ plain versions ----

def splat_planes_reference(rgb, values, *, nc: int, L: int, inv_step: float,
                           out_dtype=_F32):
    """Dense splat ``G[z] = t_lb[z] @ t_rg[z]^T``: each pixel adds
    ``bf16(bf16(v*scale) * bf16(w_b)) * bf16(w_r*w_g)`` to its grid corners,
    summed in f32.  ``rgb`` is (Z, 3, P) rgb planes (scale 1: the norm pass)
    or packed attrs (Z, 8, P) whose ``ATTR_BSCALE`` row is the scale.
    Returns (Z, nc*L, nc*nc) in ``out_dtype``."""
    Z, rows, P = rgb.shape
    scale = rgb[:, ATTR_BSCALE:ATTR_BSCALE + 1] if rows == ATTR_ROWS else None
    C, D = nc * nc, nc * L
    out = torch.empty((Z, D, C), dtype=out_dtype, device=rgb.device)
    for sl in _cell_chunks(Z, 4 * P * (C + 2 * D + 3 * nc)):
        coords = rgb[sl, :3].float() * inv_step
        v = values[sl].float()
        vb = _bf(v * scale[sl].float() if scale is not None else v)
        wb = _bf(_hat(coords[:, 2], nc))                      # (z, nc, P)
        t_lb = _bf(wb[:, :, None] * vb[:, None]).reshape(-1, D, P)
        out[sl] = torch.matmul(t_lb, _t_rg(coords, nc).transpose(1, 2)
                               ).to(out_dtype)
    return out


def _blur_slice_reference(grid, coords, *, nc: int, L: int, ctaps):
    """Color blur of the cell grids and slice at each pixel, as the TPU's
    ``_blur_slice``: bf16(grid) @ bf16(Brg) in f32, the b band in f32,
    rounded to bf16, @ t_rg in f32, then the b hat weights in f32.
    grid (Z, D, C); coords (Z, 3, P) f32.  Returns (Z, L, P) f32."""
    Z, _, P = coords.shape
    C, D = nc * nc, nc * L
    R = len(ctaps) // 2
    brg = _brg_bf16(nc, ctaps, grid.device)
    out = torch.empty((Z, L, P), dtype=_F32, device=grid.device)
    for sl in _cell_chunks(Z, 4 * (P * (C + 2 * D + nc) + 3 * D * C)):
        g = torch.matmul(_bf(grid[sl].float()), brg).reshape(-1, nc, L, C)
        pieces = []
        for b in range(nc):
            acc = None
            for off in range(-R, R + 1):
                if 0 <= b + off < nc:
                    term = g[:, b + off] * float(ctaps[off + R])
                    acc = term if acc is None else acc + term
            pieces.append(acc)
        g2 = _bf(torch.stack(pieces, 1)).reshape(-1, D, C)
        m = torch.matmul(g2, _t_rg(coords[sl], nc)).reshape(-1, nc, L, P)
        wb = _hat(coords[sl, 2], nc)
        acc = m[:, 0] * wb[:, 0:1]
        for b in range(1, nc):
            acc = acc + m[:, b] * wb[:, b:b + 1]
        out[sl] = acc
    return out


def _subsample(x, stride: int, cs_y: int, cs_x: int):
    Z, R, _ = x.shape
    sub = x.reshape(Z, R, cs_y, cs_x)[:, :, ::stride, ::stride]
    return sub.reshape(Z, R, -1).contiguous()


def _q0_values(L: int, gt_prob: float):
    """softmax(-U) of the two-level unary, closed form: (on label, other)."""
    n_e = -math.log((1.0 - gt_prob) / (L - 1))
    p_e = -math.log(gt_prob)
    den = math.exp(-p_e) + (L - 1) * math.exp(-n_e)
    return math.exp(-p_e) / den, math.exp(-n_e) / den


def slice_attrs_planes_reference(rgb, grid, gn, labels, *, nc: int, L: int,
                                 inv_step: float, ctaps, stride: int,
                                 cs_y: int, cs_x: int, h: int, w: int,
                                 nx: int, Z: int, gt_prob: float):
    """Norm-pass tail: slice the z-blurred valid-mask grid (B*Z, nc, C) f32,
    then per pixel in closed form b_self, valid, b_norm, b_scale, the packed
    attrs (B*Z, 8, P) f32 and Q0 (B*Z, L, P) bf16; with ``stride`` > 1 also
    their stride-subsampled copies.  gn (Z, 1, P) f32 is indexed per image
    position; labels (B*Z, 1, P) int32."""
    BZ, _, P = rgb.shape
    rgb = rgb.float()
    coords = rgb * inv_step
    filt = _blur_slice_reference(grid, coords, nc=nc, L=1, ctaps=ctaps)
    frac = coords - torch.floor(coords)
    s0, s1 = 1.0 - frac, frac
    R = len(ctaps) // 2
    b0 = float(ctaps[R])
    b1 = float(ctaps[R + 1]) if len(ctaps) > 1 else 0.0
    per_dim = (s0 * s0 + s1 * s1) * b0 + 2.0 * s0 * s1 * b1
    b_self = per_dim[:, 0:1] * per_dim[:, 1:2] * per_dim[:, 2:3]
    zz = torch.arange(BZ, device=rgb.device) % Z
    iy, ix = (zz // nx)[:, None, None], (zz % nx)[:, None, None]
    py = torch.arange(cs_y, device=rgb.device)[:, None]
    px = torch.arange(cs_x, device=rgb.device)[None, :]
    valid = ((iy * cs_y + py < h) & (ix * cs_x + px < w)).to(_F32)
    valid = valid.reshape(BZ, 1, P)
    floor = b_self if stride > 1 else torch.full_like(b_self, 1e-20)
    bn = torch.rsqrt(torch.maximum(filt - b_self, floor))
    bscale = bn * valid * float(stride * stride)
    lab = labels.float()
    gn_b = gn.float().repeat(BZ // Z, 1, 1)
    attrs = torch.cat([rgb, gn_b, bn, b_self, lab, bscale], dim=1)
    q_lab, q_other = _q0_values(L, gt_prob)
    iota = torch.arange(L, dtype=_F32, device=rgb.device)[None, :, None]
    q0 = torch.where(iota == lab, torch.tensor(q_lab, dtype=_F32),
                     torch.tensor(q_other, dtype=_F32)).to(_BF16)
    if stride == 1:
        return attrs, q0
    return (attrs, q0, _subsample(attrs, stride, cs_y, cs_x),
            _subsample(q0, stride, cs_y, cs_x))


def gaussian_blur_planes_reference(a, gn, *, taps, B: int, ny: int,
                                   nx: int, cs_y: int, cs_x: int):
    """Separable truncated Gaussian of ``a * gn`` over the image the cells
    tile, zero outside it: A = bf16(a*gn), the y pass in f32 rounded to
    bf16, the x pass in f32, output in a's dtype; taps rounded to bf16.
    a (B*Z, L, P); gn (Z, 1, P), one plane per image position."""
    BZ, L, P = a.shape
    K = len(taps)
    r = K // 2
    tb = _bf(torch.tensor(taps, dtype=_F32, device=a.device))
    A = _bf(a.float() * gn.float().repeat(B, 1, 1))
    img = (A.reshape(B, ny, nx, L, cs_y, cs_x).permute(0, 3, 1, 4, 2, 5)
           .reshape(B * L, 1, ny * cs_y, nx * cs_x))
    t1 = _bf(F.conv2d(img, tb.view(1, 1, K, 1), padding=(r, 0)))
    t2 = F.conv2d(t1, tb.view(1, 1, 1, K), padding=(0, r)).to(a.dtype)
    return (t2.reshape(B, L, ny, cs_y, nx, cs_x).permute(0, 2, 4, 1, 3, 5)
            .reshape(BZ, L, P).contiguous())


def mf_step_planes_reference(attrs, grid, f_gauss, q, *, nc: int, L: int,
                             inv_step: float, ctaps, cg: float, cb: float,
                             n_energy: float, p_energy: float,
                             sub_stride: int = 1, cs_y: int = 0,
                             cs_x: int = 0):
    """One mean-field iteration tail: color blur and slice of the
    z-blurred grid (Z, D, C) bf16, spatial and bilateral messages, the
    two-level unary from the label row, softmax over L.  Returns (Q_next,)
    (Z, L, P) in q's dtype, plus Q_next subsampled when ``sub_stride`` > 1."""
    coords = attrs[:, :3] * inv_step
    filt = _blur_slice_reference(grid, coords, nc=nc, L=L, ctaps=ctaps)
    qf = q.float()
    gn = attrs[:, ATTR_GN:ATTR_GN + 1]
    bn = attrs[:, ATTR_BN:ATTR_BN + 1]
    lab = attrs[:, ATTR_LABEL:ATTR_LABEL + 1]
    iota = torch.arange(L, dtype=_F32, device=q.device)[None, :, None]
    u = torch.where(iota == lab, torch.tensor(p_energy, dtype=_F32),
                    torch.tensor(n_energy, dtype=_F32))
    msg_g = (f_gauss.float() - qf * gn) * gn
    msg_b = torch.clamp(
        filt - attrs[:, ATTR_BSELF:ATTR_BSELF + 1] * bn * qf, min=0.0) * bn
    logits = -u + cg * msg_g + cb * msg_b
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    q_next = (e / e.sum(dim=1, keepdim=True)).to(q.dtype)
    if sub_stride > 1:
        return q_next, _subsample(q_next, sub_stride, cs_y, cs_x)
    return (q_next,)


# ------------------------------------------------------------ wrappers ----

_VOID, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    "crf_splat_launch": [_VOID, _INT, _VOID, _INT, _VOID, _INT, _INT, _INT,
                         _INT, _INT, _FLT, _VOID],
    "crf_slice_attrs_launch": [_VOID] * 10 + [_INT] * 12 + [_FLT] * 3
                              + [_VOID],
    "crf_blur_launch": [_VOID] * 4 + [_INT] * 7 + [_VOID],
    "crf_mf_step_launch": [_VOID] * 8 + [_INT] * 7 + [_FLT] * 5
                          + [_VOID],
}


def _lib():
    from deeplab_tpu_torch.kernels import build
    lib = build.load("crf_fused")
    if lib.crf_error.restype is not ctypes.c_char_p:
        for name, sig in _SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes = sig
            fn.restype = ctypes.c_int
        lib.crf_error.argtypes = [ctypes.c_int]
        lib.crf_error.restype = ctypes.c_char_p
    return lib


def _ok(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.crf_error(rc).decode())


def _check(name: str, t: torch.Tensor, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return True


def _check_grid(nc: int, inv_step: float, L: int):
    if not nc >= 255.0 * inv_step + 1:
        raise ValueError(f"nc={nc} does not cover 0-255 at inv_step "
                         f"{inv_step}")
    if L < 1:
        raise ValueError(f"L={L}: need at least one label")


@functools.lru_cache(maxsize=16)
def _color_taps_host(ctaps: tuple) -> np.ndarray:
    """The color taps as the kernels take them, n^2 + n f32 values: the
    joint (r, g) weights bf16(t_i * t_j), the entries of :func:`_brg_bf16`
    at offsets (i - R, j - R), then the f32 b band t."""
    t = np.asarray(ctaps, np.float32)
    if len(t) % 2 != 1 or len(t) > MAX_COLOR_TAPS:
        raise ValueError(f"color taps: odd count <= {MAX_COLOR_TAPS}, "
                         f"got {len(t)}")
    rg = _bf(torch.from_numpy(np.outer(t, t))).numpy().reshape(-1)
    return np.ascontiguousarray(np.concatenate([rg, t]), np.float32)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def splat_planes(rgb, values, *, nc: int, L: int, inv_step: float,
                 out_dtype=_F32):
    """Same arguments as :func:`splat_planes_reference`.  The kernel takes
    f32 values with an f32 grid (the norm pass) or bf16 values with a bf16
    grid (the iterations)."""
    if not _on_cuda(rgb, "splat_planes"):
        return splat_planes_reference(rgb, values, nc=nc, L=L,
                                      inv_step=inv_step, out_dtype=out_dtype)
    Z, rows, P = rgb.shape
    dev = rgb.device
    _check_grid(nc, inv_step, L)
    if rows not in (3, ATTR_ROWS):
        raise ValueError(f"rgb planes have 3 or {ATTR_ROWS} rows, not {rows}")
    pair = {(_F32, _F32), (_BF16, _BF16)}
    if (values.dtype, out_dtype) not in pair:
        raise ValueError(f"values {values.dtype} -> grid {out_dtype}: the "
                         f"kernel takes f32 -> f32 or bf16 -> bf16")
    _check("rgb", rgb, (Z, rows, P), (_F32,), dev)
    _check("values", values, (Z, L, P), (values.dtype,), dev)
    out = torch.empty((Z, nc * L, nc * nc), dtype=out_dtype, device=dev)
    lib = _lib()
    rc = lib.crf_splat_launch(
        rgb.data_ptr(), rows, values.data_ptr(), int(values.dtype == _BF16),
        out.data_ptr(), int(out_dtype == _BF16), Z, P, L, nc, inv_step,
        _stream(rgb))
    _ok(lib, rc, "splat_planes")
    splat_planes.launches += 1
    return out


def slice_attrs_planes(rgb, grid, gn, labels, *, nc: int, L: int,
                       inv_step: float, ctaps, stride: int, cs_y: int,
                       cs_x: int, h: int, w: int, nx: int, Z: int,
                       gt_prob: float):
    """Same arguments as :func:`slice_attrs_planes_reference`."""
    kw = dict(nc=nc, L=L, inv_step=inv_step, ctaps=ctaps, stride=stride,
              cs_y=cs_y, cs_x=cs_x, h=h, w=w, nx=nx, Z=Z, gt_prob=gt_prob)
    if not _on_cuda(rgb, "slice_attrs_planes"):
        return slice_attrs_planes_reference(rgb, grid, gn, labels, **kw)
    BZ, _, P = rgb.shape
    dev = rgb.device
    _check_grid(nc, inv_step, L)
    if P != cs_y * cs_x or BZ % Z or cs_y % stride or cs_x % stride:
        raise ValueError(f"bad cell geometry P={P} cs={cs_y}x{cs_x} "
                         f"stride={stride} BZ={BZ} Z={Z}")
    C = nc * nc
    _check("rgb", rgb, (BZ, 3, P), (_F32,), dev)
    _check("grid", grid, (BZ, nc, C), (_F32,), dev)
    _check("gn", gn, (Z, 1, P), (_F32,), dev)
    _check("labels", labels, (BZ, 1, P), (torch.int32,), dev)
    pack = _color_taps_host(tuple(ctaps))
    attrs = torch.empty((BZ, ATTR_ROWS, P), dtype=_F32, device=dev)
    q0 = torch.empty((BZ, L, P), dtype=_BF16, device=dev)
    Ps = P // (stride * stride)
    if stride > 1:
        attrs_s = torch.empty((BZ, ATTR_ROWS, Ps), dtype=_F32, device=dev)
        q0_s = torch.empty((BZ, L, Ps), dtype=_BF16, device=dev)
    scratch = torch.empty((BZ, nc, C), dtype=_BF16, device=dev)
    q_lab, q_other = _q0_values(L, gt_prob)
    lib = _lib()
    rc = lib.crf_slice_attrs_launch(
        rgb.data_ptr(), grid.data_ptr(), scratch.data_ptr(), gn.data_ptr(),
        labels.data_ptr(), attrs.data_ptr(), q0.data_ptr(),
        attrs_s.data_ptr() if stride > 1 else None,
        q0_s.data_ptr() if stride > 1 else None,
        pack.ctypes.data, len(ctaps), BZ, Z, P, L, nc, stride, cs_y, cs_x,
        h, w, nx, inv_step, q_lab, q_other, _stream(rgb))
    _ok(lib, rc, "slice_attrs_planes")
    slice_attrs_planes.launches += 1
    if stride == 1:
        return attrs, q0
    return attrs, q0, attrs_s, q0_s


def gaussian_blur_planes(a, gn, *, taps, B: int, ny: int, nx: int,
                         cs_y: int, cs_x: int):
    """Same arguments as :func:`gaussian_blur_planes_reference`; the kernel
    takes bf16 ``a``, cells whose width is a multiple of 4 and a radius
    within one cell."""
    kw = dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    if not _on_cuda(a, "gaussian_blur_planes"):
        return gaussian_blur_planes_reference(a, gn, **kw)
    BZ, L, P = a.shape
    dev = a.device
    Z = ny * nx
    r = len(taps) // 2
    if (len(taps) % 2 != 1 or len(taps) > MAX_SPATIAL_TAPS
            or r > min(cs_y, cs_x) or cs_x % 4 or P != cs_y * cs_x
            or BZ != B * Z):
        raise ValueError(f"bad blur geometry: {len(taps)} taps, cells "
                         f"{cs_y}x{cs_x}, P={P}, BZ={BZ}, B*Z={B * Z}")
    _check("a", a, (BZ, L, P), (_BF16,), dev)
    _check("gn", gn, (Z, 1, P), (_F32,), dev)
    tb = _bf(torch.tensor(taps, dtype=_F32)).numpy()
    out = torch.empty_like(a)
    lib = _lib()
    rc = lib.crf_blur_launch(
        a.data_ptr(), gn.data_ptr(), out.data_ptr(), tb.ctypes.data,
        len(tb), B, ny, nx, cs_y, cs_x, L, _stream(a))
    _ok(lib, rc, "gaussian_blur_planes")
    gaussian_blur_planes.launches += 1
    return out


def mf_step_planes(attrs, grid, f_gauss, q, *, nc: int, L: int,
                   inv_step: float, ctaps, cg: float, cb: float,
                   n_energy: float, p_energy: float, sub_stride: int = 1,
                   cs_y: int = 0, cs_x: int = 0):
    """Same arguments as :func:`mf_step_planes_reference`."""
    kw = dict(nc=nc, L=L, inv_step=inv_step, ctaps=ctaps, cg=cg, cb=cb,
              n_energy=n_energy, p_energy=p_energy, sub_stride=sub_stride,
              cs_y=cs_y, cs_x=cs_x)
    if not _on_cuda(attrs, "mf_step_planes"):
        return mf_step_planes_reference(attrs, grid, f_gauss, q, **kw)
    Z, _, P = attrs.shape
    dev = attrs.device
    _check_grid(nc, inv_step, L)
    if sub_stride > 1 and (P != cs_y * cs_x or cs_y % sub_stride
                           or cs_x % sub_stride):
        raise ValueError(f"bad cell geometry P={P} cs={cs_y}x{cs_x} "
                         f"sub_stride={sub_stride}")
    C, D = nc * nc, nc * L
    _check("attrs", attrs, (Z, ATTR_ROWS, P), (_F32,), dev)
    _check("grid", grid, (Z, D, C), (_BF16,), dev)
    _check("f_gauss", f_gauss, (Z, L, P), (_BF16,), dev)
    _check("q", q, (Z, L, P), (_BF16,), dev)
    pack = _color_taps_host(tuple(ctaps))
    out = torch.empty_like(q)
    sub = None
    if sub_stride > 1:
        sub = torch.empty((Z, L, P // (sub_stride * sub_stride)),
                          dtype=_BF16, device=dev)
    scratch = torch.empty((Z, D, C), dtype=_BF16, device=dev)
    lib = _lib()
    rc = lib.crf_mf_step_launch(
        attrs.data_ptr(), grid.data_ptr(), scratch.data_ptr(),
        f_gauss.data_ptr(), q.data_ptr(), out.data_ptr(),
        sub.data_ptr() if sub is not None else None,
        pack.ctypes.data, len(ctaps), Z, P, L, nc, max(sub_stride, 1),
        cs_x, inv_step, cg, cb, n_energy, p_energy, _stream(attrs))
    _ok(lib, rc, "mf_step_planes")
    mf_step_planes.launches += 1
    if sub is not None:
        return out, sub
    return (out,)


splat_planes.launches = 0
slice_attrs_planes.launches = 0
gaussian_blur_planes.launches = 0
mf_step_planes.launches = 0


# ---------------------------------------- kernels against plain versions ----

@contextlib.contextmanager
def plain_versions():
    """Within the block each wrapper of this module runs its plain version,
    on any device, and records the call: yields {name: [(args, kw, out)]}
    in call order.  The launch counts do not move."""
    mod = sys.modules[__name__]
    calls = {n: [] for n in KERNELS}
    saved = {n: getattr(mod, n) for n in KERNELS}

    def recorder(name):
        ref = getattr(mod, name + "_reference")

        def call(*args, **kw):
            out = ref(*args, **kw)
            calls[name].append((args, kw, out))
            return out
        return call
    for n in KERNELS:
        setattr(mod, n, recorder(n))
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(mod, n, f)


def max_err_vs_plain(name: str, got, want):
    """Kernel ``name``'s result against its plain version's on the same
    inputs: (largest abs error over the outputs, whether every output, and
    every attrs row, is within its ``PLAIN_*_REL`` tolerance)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise ValueError(f"{name}: {len(got)} outputs, want {len(want)}")
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise ValueError(f"{name}: {g.dtype} {tuple(g.shape)}, want "
                             f"{w.dtype} {tuple(w.shape)}")
        if g.dtype == _F32 and name == "slice_attrs_planes":
            pairs = [(g[:, k], w[:, k], PLAIN_BF16_REL if k in (
                ATTR_BN, ATTR_BSCALE) else PLAIN_F32_REL)
                for k in range(ATTR_ROWS)]
        elif g.dtype == _F32:
            pairs = [(g, w, PLAIN_F32_REL)]
        else:
            pairs = [(g, w, PLAIN_STEP_REL if name == "mf_step_planes"
                      else PLAIN_BF16_REL)]
        for a, b, rel in pairs:
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            ok = ok and math.isfinite(err) and err <= rel * scale
            worst = max(worst, err)
    return worst, ok
