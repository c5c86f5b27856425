"""The dense CRF's kernels on cell planes: splat, norm-pass slice, spatial
blur, mean-field step, and the plain color blur and slice of the XLA
engine, each beside its plain PyTorch version.

Replaces the TPU kernels of ``deeplab_tpu/kernels/crf_fused.py``:

- ``splat_planes`` (its ``pl.pallas_call`` at line 702),
- ``slice_attrs_planes`` (line 890),
- ``gaussian_blur_planes``: the fused row kernel (line 568) and, where its
  geometry does not fit, the y pass (line 628) then the x pass (line 638),
  ``gaussian_blur_y_planes`` and ``gaussian_blur_x_planes``,
- ``mf_step_planes`` (line 988), with the unary rebuilt from the label row
  or read from an explicit (Z, L, P) stream,
- ``slice_planes`` (line 731).

The CUDA source is ``csrc/crf_fused.cu``; its header says what bounds each
kernel on the H100 and how the design deals with it.  The TPU forms the
splat and the slice as dense products against hat-factor matrices; a pixel
touches only 2 bins per color channel, so the CUDA kernels scatter and
gather the 8 grid corners of each pixel instead.  The plain versions here
(``*_reference``) keep the dense formulation: f32 products of the same
bf16-rounded operands, so a kernel and its plain version differ only in
summation order.  A CPU tensor runs the plain version; a CUDA tensor runs
the kernel or raises.  The launch geometry of the row blur
(:func:`blur_plan`), the splat (:func:`splat_plan`) and the mean-field step
(:func:`step_plan`: fused, or two kernels where a cell's grid does not fit
in shared memory) is plain Python, decided from shapes alone; the
launchers check it against their own shared-memory layout.

Layouts (the TPU's tile padding of the grid is dropped): rgb planes
(Z, 3, P) f32 0-255; packed attrs (Z, 8, P) f32 (``ATTR_*`` rows); values
and Q (Z, L, P); grids (Z, D, C) with D = nc*L (d = b*L + l) and C = nc^2
(c = r*nc + g).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from deeplab_tpu_torch.kernels import ops as OPS

# Packed per-pixel attribute rows of the (Z, 8, P) f32 attrs planes.
ATTR_RGB = 0      # rows 0-2: r, g, b in 0-255
ATTR_GN = 3       # spatial-Gaussian normalization 1/sqrt(ksum)
ATTR_BN = 4       # bilateral normalization 1/sqrt(ksum)
ATTR_BSELF = 5    # bilateral self-weight
ATTR_LABEL = 6    # hard label (exact small ints in f32)
ATTR_BSCALE = 7   # splat-side scale: b_norm * valid * stride^2
ATTR_ROWS = 8

# the plane engine's kernels, and the XLA engine's (crf/dense_crf.py)
KERNELS = ("splat_planes", "slice_attrs_planes", "gaussian_blur_planes",
           "mf_step_planes")
XLA_KERNELS = ("splat_planes", "slice_planes")
# the spatial blur's two passes, which gaussian_blur_planes runs where its
# row kernel's geometry does not fit
BLUR_PASSES = ("gaussian_blur_y_planes", "gaussian_blur_x_planes")

# A kernel against its plain version on the same inputs, relative to the
# largest value of each output (of each attrs row): both take the same
# bf16-rounded operands, whose products are exact in f32, and differ in
# summation order.  f32 outputs 1e-4; bf16 outputs, and the f32 values sliced
# from a bf16-rounded grid (the b_norm/b_scale rows, slice_planes), 2 bf16
# ulps (one rounding may flip); the step's Q 4 ulps (a flipped grid rounding moves a logit by
# cb * b_norm * 2^-8 of the slice).
PLAIN_F32_REL, PLAIN_BF16_REL, PLAIN_STEP_REL = 1e-4, 2.0 ** -7, 2.0 ** -6

MAX_COLOR_TAPS = 7    # color band radius <= 3
MAX_SPATIAL_TAPS = 33  # the fused row kernel: spatial radius <= 16
MAX_YX_TAPS = 257      # the y and x passes: spatial radius <= 128
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


def _blur_slice(grid, coords, *, nc: int, L: int, ctaps):
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


def slice_planes_reference(rgb, grid, *, nc: int, L: int, inv_step: float,
                           ctaps):
    """Color blur and slice of a z-blurred grid (Z, nc*L, nc*nc) f32 at the
    pixels of the rgb planes (Z, 3, P) f32 0-255 (the TPU's ``_blur_slice``).
    Returns (Z, L, P) f32."""
    return _blur_slice(grid, rgb.float() * inv_step, nc=nc, L=L, ctaps=ctaps)


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
    filt = _blur_slice(grid, coords, nc=nc, L=1, ctaps=ctaps)
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


def _gn_cells(gn, BZ: int):
    """The spatial normalization as (B*Z, 1, P) f32 from either JAX form:
    (Z, 1, P), one plane per image position shared by the batch, or
    (B*Z, 1, P), one per cell."""
    gn = gn.float()
    return gn if gn.shape[0] == BZ else gn.repeat(BZ // gn.shape[0], 1, 1)


def _image(x, B: int, ny: int, nx: int, cs_y: int, cs_x: int):
    """(B*Z, L, P) cell planes -> (B, L, ny*cs_y, nx*cs_x) images."""
    L = x.shape[1]
    return (x.reshape(B, ny, nx, L, cs_y, cs_x).permute(0, 3, 1, 4, 2, 5)
            .reshape(B, L, ny * cs_y, nx * cs_x))


def _planes(img, ny: int, nx: int, cs_y: int, cs_x: int):
    """The inverse of :func:`_image`."""
    B, L = img.shape[:2]
    return (img.reshape(B, L, ny, cs_y, nx, cs_x).permute(0, 2, 4, 1, 3, 5)
            .reshape(B * ny * nx, L, cs_y * cs_x).contiguous())


def _spatial_taps(taps, device):
    return _bf(torch.tensor(taps, dtype=_F32, device=device))


def _tap_sum(img, tb, dim: int):
    """sum_k tb[k] * img[.. i + k - r ..] along ``dim``, zero outside the
    image, in f32 in tap order (as the y and x kernels sum)."""
    r = len(tb) // 2
    n = img.shape[dim]
    pad = [0, 0] * (img.dim() - 1 - dim) + [r, r]
    padded = F.pad(img, pad)
    acc = None
    for k, t in enumerate(tb.tolist()):
        term = padded.narrow(dim, k, n) * t
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur_y_planes_reference(a, gn, *, taps, B: int, ny: int,
                                     nx: int, cs_y: int, cs_x: int):
    """The y pass of :func:`gaussian_blur_planes_reference` (the TPU's
    ``_blur_y_kernel``): A = bf16(a*gn) in f32; down each image column the
    bf16 taps times A summed in f32 in tap order, zero above and below the
    image (so nothing crosses from one image of the batch to the next);
    rounded to a's dtype.  a (B*Z, L, P); gn (Z, 1, P) or (B*Z, 1, P)."""
    A = _bf(a.float() * _gn_cells(gn, a.shape[0]))
    y = _tap_sum(_image(A, B, ny, nx, cs_y, cs_x),
                 _spatial_taps(taps, a.device), 2)
    return _planes(y.to(a.dtype), ny, nx, cs_y, cs_x)


def gaussian_blur_x_planes_reference(f, *, taps, B: int, ny: int, nx: int,
                                     cs_y: int, cs_x: int):
    """The x pass (the TPU's ``_blur_x_kernel``): bf16(f) times the bf16
    taps along each image row, summed in f32 in tap order, zero left and
    right of the image; written in f's dtype.  f (B*Z, L, P), the y pass's
    output."""
    x = _tap_sum(_image(_bf(f.float()), B, ny, nx, cs_y, cs_x),
                 _spatial_taps(taps, f.device), 3)
    return _planes(x.to(f.dtype), ny, nx, cs_y, cs_x)


def gaussian_blur_planes_reference(a, gn, *, taps, B: int, ny: int,
                                   nx: int, cs_y: int, cs_x: int):
    """Separable truncated Gaussian of ``a * gn`` over the image the cells
    tile, zero outside it: A = bf16(a*gn), the y pass in f32 rounded to
    bf16, the x pass in f32, output in a's dtype; taps rounded to bf16.
    a (B*Z, L, P); gn (Z, 1, P), one plane per image position, or
    (B*Z, 1, P), one per cell.  The y pass then the x pass compute the
    same function."""
    BZ, L, P = a.shape
    K = len(taps)
    r = K // 2
    tb = _spatial_taps(taps, a.device)
    A = _bf(a.float() * _gn_cells(gn, BZ))
    img = _image(A, B, ny, nx, cs_y, cs_x).reshape(B * L, 1, ny * cs_y,
                                                   nx * cs_x)
    t1 = _bf(F.conv2d(img, tb.view(1, 1, K, 1), padding=(r, 0)))
    t2 = F.conv2d(t1, tb.view(1, 1, 1, K), padding=(0, r)).to(a.dtype)
    return _planes(t2.reshape(B, L, ny * cs_y, nx * cs_x), ny, nx, cs_y,
                   cs_x)


def mf_step_planes_reference(attrs, grid, f_gauss, q, unary=None, *, nc: int,
                             L: int, inv_step: float, ctaps, cg: float,
                             cb: float, n_energy: float = 0.0,
                             p_energy: float = 0.0, sub_stride: int = 1,
                             cs_y: int = 0, cs_x: int = 0):
    """One mean-field iteration tail: color blur and slice of the
    z-blurred grid (Z, D, C) bf16, spatial and bilateral messages, the
    unary, softmax over L.  The unary is the two-level one rebuilt from the
    label row with ``(n_energy, p_energy)`` (the serving path), or the
    explicit energies ``unary`` (Z, L, P) bf16.  Returns (Q_next,) (Z, L, P)
    in q's dtype, plus Q_next subsampled when ``sub_stride`` > 1."""
    coords = attrs[:, :3] * inv_step
    filt = _blur_slice(grid, coords, nc=nc, L=L, ctaps=ctaps)
    qf = q.float()
    gn = attrs[:, ATTR_GN:ATTR_GN + 1]
    bn = attrs[:, ATTR_BN:ATTR_BN + 1]
    if unary is None:
        lab = attrs[:, ATTR_LABEL:ATTR_LABEL + 1]
        iota = torch.arange(L, dtype=_F32, device=q.device)[None, :, None]
        u = torch.where(iota == lab, torch.tensor(p_energy, dtype=_F32),
                        torch.tensor(n_energy, dtype=_F32))
    else:
        u = unary.float()
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
                         _INT, _INT, _FLT] + [_INT] * 4 + [_VOID],
    "crf_slice_attrs_launch": [_VOID] * 10 + [_INT] * 12 + [_FLT] * 3
                              + [_VOID],
    "crf_blur_launch": [_VOID] * 4 + [_INT] * 11 + [_VOID],
    "crf_blur_y_launch": [_VOID, _VOID, _INT, _VOID, _VOID] + [_INT] * 11
                         + [_VOID],
    "crf_blur_x_launch": [_VOID] * 3 + [_INT] * 11 + [_VOID],
    "crf_mf_step_launch": [_VOID] * 9 + [_INT] * 12 + [_FLT] * 5
                          + [_VOID],
    "crf_slice_launch": [_VOID] * 4 + [_INT] * 5 + [_FLT] + [_INT] * 6
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


def _floats(taps) -> list:
    """Taps as the operators' ``float[]`` argument."""
    return [float(t) for t in taps]


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def splat_planes(rgb, values, *, nc: int, L: int, inv_step: float,
                 out_dtype=_F32):
    """Same arguments as :func:`splat_planes_reference`.  The kernel takes
    f32 values with an f32 grid (the norm pass) or bf16 values with a bf16
    grid (the iterations)."""
    _on_cuda(rgb, "splat_planes")
    return _splat_op(rgb, values, nc, L, inv_step, out_dtype)


def _splat_cuda(rgb, values, nc, L, inv_step, out_dtype):
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
    plan = splat_plan(Z, P, L, nc)
    lib = _lib()
    rc = lib.crf_splat_launch(
        rgb.data_ptr(), rows, values.data_ptr(), int(values.dtype == _BF16),
        out.data_ptr(), int(out_dtype == _BF16), Z, P, L, nc, inv_step,
        plan.lg, plan.pc, plan.k, plan.smem, _stream(rgb))
    _ok(lib, rc, "splat_planes")
    splat_planes.launches += 1
    return out


def slice_attrs_planes(rgb, grid, gn, labels, *, nc: int, L: int,
                       inv_step: float, ctaps, stride: int, cs_y: int,
                       cs_x: int, h: int, w: int, nx: int, Z: int,
                       gt_prob: float):
    """Same arguments as :func:`slice_attrs_planes_reference`."""
    _on_cuda(rgb, "slice_attrs_planes")
    return tuple(_slice_attrs_op(rgb, grid, gn, labels, nc, L, inv_step,
                                 _floats(ctaps), stride, cs_y, cs_x, h, w,
                                 nx, Z, gt_prob))


def _slice_attrs_cuda(rgb, grid, gn, labels, nc, L, inv_step, ctaps, stride,
                      cs_y, cs_x, h, w, nx, Z, gt_prob):
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
        return [attrs, q0]
    return [attrs, q0, attrs_s, q0_s]


# Launch geometry of the row kernel (csrc/crf_fused.cu ``blur_kernel``),
# decided here and checked there.
BLUR_SMEM_LIMIT = 232448   # dynamic shared memory a block may use (H100)
BLUR_MAX_THREADS = 384     # two blocks an SM at 85 registers a thread
BLUR_SLOTS = 2 * 132       # blocks resident at once: two an SM, 132 SMs


def blur_ry(ntaps: int) -> int:
    """Rows of a y-pass thread's register window: 16 for the main path's
    17 taps (its own instantiation), 8 for any other count."""
    return 16 if ntaps == 17 else 8


@dataclasses.dataclass(frozen=True)
class BlurPlan:
    """One row-kernel launch: a block of ``threads`` per (cell, strip of
    ``ty`` rows, group of ``lg`` labels); ``wp`` the row pitch (elements)
    of its gn, A and T tiles, ``smem`` their bytes; grid
    ``(B*Z, strips, groups)``."""
    ty: int
    strips: int
    lg: int
    groups: int
    wp: int
    threads: int
    smem: int
    BZ: int

    @property
    def grid(self):
        return (self.BZ, self.strips, self.groups)


def blur_smem(ty: int, cs_x: int, ntaps: int) -> int:
    """Bytes of a row-kernel block: the f32 gn tile and the bf16 A tile of
    ``ty`` rows (rounded up to the y pass's windows) plus 2r halo rows, and
    the bf16 y-pass tile T; rows of cs_x + 2r padded to 8 elements."""
    r, ry = ntaps // 2, blur_ry(ntaps)
    wp = -(-(cs_x + 2 * r) // 8) * 8
    ty_p = -(-ty // ry) * ry
    return (ty_p + 2 * r) * wp * (4 + 2) + ty_p * wp * 2


@functools.lru_cache(maxsize=256)
def blur_plan(B: int, ny: int, nx: int, cs_y: int, cs_x: int, L: int,
              ntaps: int) -> BlurPlan:
    """Whole cells a block where they fit (a halo of 2r rows read once per
    cell, not once per strip), else the fewest even strips that do.  The
    labels split into as many groups as keep the blocks within one wave of
    BLUR_SLOTS (all 21 labels of a cell in one block at B=8 in production:
    one gn tile for all of them), spread evenly.  One thread per y-pass
    window (a column pair and blur_ry rows), in as few rounds of at most
    BLUR_MAX_THREADS as hold them."""
    strips = 1
    while True:
        ty = -(-cs_y // strips)
        smem = blur_smem(ty, cs_x, ntaps)
        if smem <= BLUR_SMEM_LIMIT:
            break
        if ty == 1:
            raise ValueError(f"no row-kernel tile fits cells {cs_y}x{cs_x} "
                             f"with {ntaps} taps")
        strips += 1
    strips = -(-cs_y // ty)
    cells = B * ny * nx * strips
    groups = min(L, max(1, BLUR_SLOTS // cells))
    lg = -(-L // groups)
    groups = -(-L // lg)
    r, ry = ntaps // 2, blur_ry(ntaps)
    wp = -(-(cs_x + 2 * r) // 8) * 8
    windows = (cs_x + 2 * r) // 2 * -(-ty // ry)
    rounds = -(-windows // BLUR_MAX_THREADS)
    threads = -(-windows // (32 * rounds)) * 32
    return BlurPlan(ty, strips, lg, groups, wp, threads, smem, B * ny * nx)


def row_kernel_fits(taps, cs_x: int, per_cell_gn: bool = False) -> bool:
    """Whether :func:`gaussian_blur_planes` runs the fused row kernel: a
    radius within its 16-row halo, cells whose width is a multiple of 4, and
    gn in its (Z, 1, P) form (``per_cell_gn`` False).  Any cell height: the
    kernel stages its halo rows by image row, and :func:`blur_plan` fits the
    heights that ``CellPlan`` gives (40 to 80 rows at 128 px) whole.  The
    TPU's clauses on the height (a multiple of 16, for its 16-row sublane
    halo strips) and on a row of cells' size (2 MiB of VMEM) are dropped."""
    return len(taps) // 2 <= 16 and cs_x % 4 == 0 and not per_cell_gn


# Launch geometry of the splat (csrc/crf_fused.cu ``splat_kernel``),
# decided here and checked there.
SPLAT_THREADS = 1024
SPLAT_MAX_PPT = 2            # pixels of a chunk a thread holds
SPLAT_CHUNKS = (2048, 1024, 512)
SPLAT_PIECE = 32             # pixels of one key a thread sums (k)
SPLAT_SLOTS = 132            # blocks resident at once: one an SM


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def splat_hist_len(nc: int) -> int:
    """Entries of the splat's key histogram: (nc + 1)^3 keys (bins -1 ..
    nc - 1 per axis), padded so that each thread owns a whole number of
    groups of four."""
    per = -(-((nc + 1) ** 3) // SPLAT_THREADS)
    return -(-per // 4) * 4 * SPLAT_THREADS


def splat_smem(nc: int, lg: int, pc: int) -> int:
    """Bytes of a splat block (``splat_layout`` in the source): the f32 grid
    [nc][lg][nc^2], the key histogram, the pieces (8 bytes), the sorted
    weights (8 + 4 bytes a pixel), the sorted bf16 values [pc][lg], the
    scan's 32 warp sums."""
    hist = _align16(4 * nc * lg * nc * nc)
    vals = _align16(hist + 4 * splat_hist_len(nc) + 20 * pc)
    return _align16(vals + 2 * pc * lg) + 4 * 32


@dataclasses.dataclass(frozen=True)
class SplatPlan:
    """One splat launch: a block of SPLAT_THREADS per (cell, group of
    ``lg`` labels); the cell's pixels in chunks of ``pc``, sorted by key
    and summed in pieces of at most ``k``; ``smem`` bytes; grid
    ``(Z, groups)``."""
    lg: int
    groups: int
    pc: int
    k: int
    smem: int
    Z: int

    @property
    def grid(self):
        return (self.Z, self.groups)


@functools.lru_cache(maxsize=256)
def splat_plan(Z: int, P: int, L: int, nc: int) -> SplatPlan:
    """The fewest label groups that fit (each group sorts the cell again),
    but at least as many as fill SPLAT_SLOTS blocks where the labels allow;
    labels spread evenly over the groups; then the largest chunk of
    SPLAT_CHUNKS (a chunk's histogram is cleared and scanned once)."""
    best = None
    for pc0 in SPLAT_CHUNKS:
        pc = min(pc0, -(-P // 4) * 4)
        lg_max = 0
        while lg_max < L and splat_smem(nc, lg_max + 1, pc) <= BLUR_SMEM_LIMIT:
            lg_max += 1
        if lg_max == 0:
            continue
        groups = max(-(-L // lg_max), min(L, -(-SPLAT_SLOTS // Z)))
        lg = -(-L // groups)
        groups = -(-L // lg)
        if best is None or groups < best.groups:
            best = SplatPlan(lg, groups, pc, SPLAT_PIECE,
                             splat_smem(nc, lg, pc), Z)
    if best is None:
        raise ValueError(f"no splat tile fits nc={nc}")
    return best


# The step's form and geometry (csrc/crf_fused.cu ``crf_mf_step_launch``).
STEP_THREADS = 512    # a fused block's threads, a pixel each
STEP_L21 = 21         # the label count of the fused kernel's own instantiation
STEP_THREADS_L21 = 1024   # its threads (the label loops unrolled)
STEP_LMAX = 32        # labels whose logits a thread holds in registers
STEP_SEG = 8          # blur outputs a thread computes along g
STEP_SLOTS = 132      # fused blocks resident at once: one an SM


def step_ncp(nc: int) -> int:
    """Row pitch (f32) of the blur's (r, g) pass: nc rounded up to a
    whole number of STEP_SEG segments."""
    return -(-nc // STEP_SEG) * STEP_SEG


def step_fused_smem(nc: int, L: int, lb: int) -> int:
    """Bytes of the fused step kernel: the cell's bf16 grid (nc*L, nc^2)
    with 16 bytes of room to keep its alignment, then the (r, g) pass's f32
    scratch of ``lb`` labels, [lb][nc][nc][step_ncp]."""
    return (_align16(2 * (nc * L * nc * nc + 8))
            + 4 * lb * nc * nc * step_ncp(nc))


STEP_LC = 4           # labels a chunk of the two-kernel form's scratch


def step_blur_smem(nc: int) -> int:
    """Bytes of the two-kernel form's grid blur (one chunk of STEP_LC labels
    a block): a label's bf16 planes, the (r, g) pass's f32 scratch, and the
    chunk's bf16 tile [nc^3][STEP_LC]."""
    return (_align16(2 * nc * nc * nc) + 4 * nc * nc * step_ncp(nc)
            + 2 * STEP_LC * nc ** 3)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The step's form: ``fused`` (one launch of ``splits`` blocks a cell,
    each blurring the cell's grid ``lb`` labels a round in shared memory
    and taking every splits-th chunk of :func:`step_threads` pixels) or two
    kernels
    (the grid blur into a scratch of ``lp`` / STEP_LC chunks, each
    (nc^3, STEP_LC) label-innermost, then the pixel pass); ``smem`` the
    bytes of the fused kernel or of the blur kernel."""
    fused: bool
    lb: int
    splits: int
    lp: int
    smem: int


def step_threads(L: int) -> int:
    """Threads of a fused block, one a pixel: STEP_THREADS_L21 for the
    STEP_L21 labels of its own instantiation, else STEP_THREADS."""
    return STEP_THREADS_L21 if L == STEP_L21 else STEP_THREADS


def step_fits(nc: int, L: int) -> bool:
    """Whether the fused step runs: the cell's grid and one label's (r, g)
    scratch fit in a block's shared memory, and a pixel's L logits in its
    thread's registers."""
    return L <= STEP_LMAX and step_fused_smem(nc, L, 1) <= BLUR_SMEM_LIMIT


@functools.lru_cache(maxsize=256)
def step_plan(Z: int, P: int, nc: int, L: int) -> StepPlan:
    """The fused form wherever :func:`step_fits`, elsewhere the two
    kernels.  Fused: as many labels a blur round as fit, spread evenly over
    the rounds; one block a cell, or where the cells are fewer than
    STEP_SLOTS, as many blocks a cell as fill them (each blurs the grid
    again) up to one a pixel chunk."""
    if not step_fits(nc, L):
        return two_kernel_step_plan(nc, L)
    lb = 1
    while lb < L and step_fused_smem(nc, L, lb + 1) <= BLUR_SMEM_LIMIT:
        lb += 1
    lb = -(-L // -(-L // lb))
    splits = 1 if Z >= STEP_SLOTS else min(-(-STEP_SLOTS // Z),
                                           -(-P // step_threads(L)))
    return StepPlan(True, lb, splits, 0, step_fused_smem(nc, L, lb))


def two_kernel_step_plan(nc: int, L: int) -> StepPlan:
    """The two-kernel form at any geometry (for a grid that does not fit,
    and to time the two forms on one input)."""
    return StepPlan(False, 0, 0, -(-L // STEP_LC) * STEP_LC,
                    step_blur_smem(nc))


# Launch geometry of slice_planes (csrc/crf_fused.cu ``slice_fused_kernel``),
# decided here and checked there.
SLICE_THREADS = 512
SLICE_LG_MAX = 8      # labels of a group: one 16-byte load a grid point
SLICE_SLOTS = 132     # SMs: blocks past one an SM share one and finish late
SLICE_LB = 2          # labels a blur round, at most (the kernel's pair
                      # stores; measured fastest, PERF.md)
SLICE_RR = 3          # (r, g) pass: output rows an item
SLICE_PAD = MAX_COLOR_TAPS // 2   # zero rows and columns around S's planes


def slice_lgp(lg: int) -> int:
    """Labels a grid point of the blurred group holds (label-innermost):
    lg rounded up to 1, 2, 4 or 8, one 2-, 4-, 8- or 16-byte load."""
    return next(n for n in (1, 2, 4, 8) if n >= lg)


def slice_xp(nc: int, L: int) -> int:
    """Pitch (f32) of a staged label's planes: C plus what keeps it
    congruent to L*C modulo 4, so that every plane sits at its device
    address's offset within 16 bytes."""
    C = nc * nc
    return C + (L - 1) * C % 4


def slice_xl(nc: int, xp: int) -> int:
    """Floats of a staged label: nc planes of xp, a whole number of 16-byte
    words with room for the planes' offset."""
    return -(-(nc * xp) // 4) * 4 + 4


def slice_smem(nc: int, L: int, lg: int, lb: int = 1,
               pad: bool = True) -> int:
    """Bytes of a slice_planes block (``slice_layout`` in the source): the
    blurred group O [nc^3][slice_lgp(lg)] bf16; a round's lb labels' bf16
    planes S, with ``pad`` SLICE_PAD zero rows and columns around each,
    [lb][nc][round_up(nc, SLICE_RR) + 2 SLICE_PAD][ncp + 2 SLICE_PAD], else
    [lb][nc][nc][nc]; the (r, g) pass's f32 Tb [lb][nc][nc][ncp], and in its
    place the f32 staging X of lb labels of slice_xl floats."""
    ncp = step_ncp(nc)
    o = _align16(2 * slice_lgp(lg) * nc ** 3)
    if pad:
        prow = -(-nc // SLICE_RR) * SLICE_RR + 2 * SLICE_PAD
        s = _align16(2 * lb * nc * prow * (ncp + 2 * SLICE_PAD))
    else:
        s = _align16(2 * lb * nc ** 3)
    tb = 4 * lb * nc * nc * ncp
    x = 4 * lb * slice_xl(nc, slice_xp(nc, L))
    return o + s + max(tb, x)


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """One slice_planes launch: a block of SLICE_THREADS per (cell, group of
    ``lg`` labels, pixel split), blurring ``lb`` labels a round; ``lgp``
    labels a grid point; S padded or not (``pad``); block (z, g, s) takes
    the pixel chunks s, s + splits, ... of SLICE_THREADS; ``smem`` bytes;
    grid ``(Z, groups, splits)``."""
    lg: int
    groups: int
    lb: int
    lgp: int
    pad: bool
    splits: int
    smem: int
    Z: int

    @property
    def grid(self):
        return (self.Z, self.groups, self.splits)


def _slice_round(nc: int, L: int, lg: int):
    """(lb, pad) at lg labels a group: padded planes where they fit
    (measured 10-25% faster than unpadded), SLICE_LB labels a round where
    they fit, else fewer; or None."""
    for pad in (True, False):
        for lb in range(min(lg, SLICE_LB), 0, -1):
            if slice_smem(nc, L, lg, lb, pad) <= BLUR_SMEM_LIMIT:
                return lb, pad
    return None


@functools.lru_cache(maxsize=256)
def slice_plan(Z: int, P: int, L: int, nc: int) -> SlicePlan:
    """Label groups as large as fit (each group works out its pixels'
    corners again) but at least as many as give two blocks an SM where the
    labels allow (a group blurs only its own labels, so more groups cost no
    blur; 294 blocks of 4 labels measured 38% faster than 147 of 7 at 21
    labels, nc 21), labels spread evenly; the round of :func:`_slice_round`.
    Where the blocks fall short of one an SM (one label, as in the norm
    pass), each (cell, group) takes as many blocks as keep them within one
    an SM, each blurring the group again: up to one a chunk of
    SLICE_THREADS pixels."""
    lg_max = 0
    while (lg_max < min(L, SLICE_LG_MAX)
           and _slice_round(nc, L, lg_max + 1) is not None):
        lg_max += 1
    if lg_max == 0:
        raise ValueError(f"no slice_planes tile fits nc={nc}")
    want = min(L, -(-2 * SLICE_SLOTS // Z))
    groups = -(-L // next(g for g in range(lg_max, 0, -1)
                          if -(-L // g) >= want))
    lg = -(-L // groups)
    groups = -(-L // lg)
    lb, pad = _slice_round(nc, L, lg)
    splits = max(1, min(SLICE_SLOTS // (Z * groups), -(-P // SLICE_THREADS)))
    return SlicePlan(lg, groups, lb, slice_lgp(lg), pad, splits,
                     slice_smem(nc, L, lg, lb, pad), Z)


# Launch geometry of the spatial blur's y and x passes (csrc/crf_fused.cu
# ``blur_y_kernel``, ``blur_x_kernel``), decided here and checked there.
PASS_RY = 8             # y-pass output rows a thread (a column pair)
PASS_MAX_THREADS = 512
PASS_SLOTS = 4 * 132    # blocks a launch aims at: four an SM


def pass_halo(ntaps: int) -> int:
    """Halo columns of the x pass's tile: the radius rounded up to 8, so
    that its 16-byte words lie each in one cell."""
    return -(-(ntaps // 2) // 8) * 8


def pass_smem(ty: int, cs_x: int, ntaps: int, y_pass: bool) -> int:
    """Bytes of a pass block (``pass_layout`` in the source): the taps (f32,
    padded to 4); the y pass's row table (2 ints a row) and f32 gn and bf16
    A tiles of round_up(ty, PASS_RY) + 2r rows of round_up(cs_x, 8); the x
    pass's bf16 tile of ty rows of round_up(cs_x, 8) + 2 * pass_halo."""
    r, cx = ntaps // 2, -(-cs_x // 8) * 8
    table = _align16(4 * (-(-ntaps // 4) * 4))
    if y_pass:
        rows = -(-ty // PASS_RY) * PASS_RY + 2 * r
        return table + _align16(8 * rows) + rows * cx * (4 + 2)
    return table + ty * (cx + 2 * pass_halo(ntaps)) * 2


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """One launch of a pass: a block of ``threads`` per (cell, strip of
    ``ty`` rows, group of ``lg`` labels), ``smem`` bytes; grid
    ``(B*Z, strips, groups)``."""
    ty: int
    strips: int
    lg: int
    groups: int
    threads: int
    smem: int
    BZ: int

    @property
    def grid(self):
        return (self.BZ, self.strips, self.groups)


@functools.lru_cache(maxsize=256)
def pass_plan(B: int, ny: int, nx: int, cs_y: int, cs_x: int, L: int,
              ntaps: int, y_pass: bool) -> PassPlan:
    """Whole cells a block where the tile fits (the y pass's 2r halo rows
    read once per cell), else the fewest even strips that do; the labels
    in as few groups as give PASS_SLOTS blocks (the y pass stages gn once a
    group), spread evenly; per label one thread a y-pass item (a column
    pair by PASS_RY rows) or x-pass item (8 outputs of a row), in as few
    rounds of at most PASS_MAX_THREADS as hold them."""
    strips = 1
    while True:
        ty = -(-cs_y // strips)
        smem = pass_smem(ty, cs_x, ntaps, y_pass)
        if smem <= BLUR_SMEM_LIMIT:
            break
        if ty == 1:
            raise ValueError(f"no blur-pass tile fits cells {cs_y}x{cs_x} "
                             f"with {ntaps} taps")
        strips += 1
    strips = -(-cs_y // ty)
    cells = B * ny * nx * strips
    groups = min(L, max(1, -(-PASS_SLOTS // cells)))
    lg = -(-L // groups)
    groups = -(-L // lg)
    items = (-(-cs_x // 2) * -(-ty // PASS_RY) if y_pass
             else ty * -(-cs_x // 8))
    rounds = -(-items // PASS_MAX_THREADS)
    threads = -(-items // (32 * rounds)) * 32
    return PassPlan(ty, strips, lg, groups, threads, smem, B * ny * nx)


def _blur_geometry(a, gn, taps, B, ny, nx, cs_y, cs_x, max_taps):
    """Check a spatial blur's arguments; returns gn's batch flag (1 for one
    plane per cell, 0 for one per image position)."""
    BZ, L, P = a.shape
    Z = ny * nx
    r = len(taps) // 2
    if (len(taps) % 2 != 1 or len(taps) > max_taps or r > min(cs_y, cs_x)
            or P != cs_y * cs_x or BZ != B * Z):
        raise ValueError(f"bad blur geometry: {len(taps)} taps (at most "
                         f"{max_taps}), cells {cs_y}x{cs_x}, P={P}, BZ={BZ}, "
                         f"B*Z={B * Z}")
    _check("a", a, (BZ, L, P), (_BF16,), a.device)
    if gn is None:
        return 0
    if gn.shape[0] not in (Z, BZ):
        raise ValueError(f"gn has {gn.shape[0]} planes: want Z={Z} or "
                         f"B*Z={BZ}")
    _check("gn", gn, (gn.shape[0], 1, P), (_F32,), a.device)
    return int(gn.shape[0] != Z)


def gaussian_blur_planes(a, gn, *, taps, B: int, ny: int, nx: int,
                         cs_y: int, cs_x: int):
    """Same arguments as :func:`gaussian_blur_planes_reference`; the kernels
    take bf16 ``a`` and a radius within one cell.  Where
    :func:`row_kernel_fits` (a radius up to 16, gn (Z, 1, P)) the fused row
    kernel runs (:func:`blur_rows`); elsewhere (radii 17-128, gn
    (B*Z, 1, P)) :func:`gaussian_blur_y_planes` then
    :func:`gaussian_blur_x_planes`, which compute the same function."""
    kw = dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    _on_cuda(a, "gaussian_blur_planes")
    if not row_kernel_fits(taps, cs_x, gn.shape[0] != ny * nx):
        return gaussian_blur_x_planes(gaussian_blur_y_planes(a, gn, **kw),
                                      **kw)
    return blur_rows(a, gn, **kw)


def blur_rows(a, gn, *, taps, B: int, ny: int, nx: int, cs_y: int,
              cs_x: int):
    """Launch the fused row kernel on CUDA tensors at any geometry it
    takes (cells whose width is a multiple of 4, a radius up to 16 within
    one cell, gn (Z, 1, P)), whether or not :func:`row_kernel_fits`; each
    launch counts in ``gaussian_blur_planes.launches``.  Its geometry is
    :func:`blur_plan`'s.  A CPU tensor runs the plain version."""
    return _blur_rows_op(a, gn, _floats(taps), B, ny, nx, cs_y, cs_x)


def _blur_rows_cuda(a, gn, taps, B, ny, nx, cs_y, cs_x):
    if cs_x % 4:
        raise ValueError(f"the row kernel takes cells whose width is a "
                         f"multiple of 4, not {cs_x}")
    if _blur_geometry(a, gn, taps, B, ny, nx, cs_y, cs_x, MAX_SPATIAL_TAPS):
        raise ValueError("the row kernel takes gn (Z, 1, P), one plane per "
                         "image position")
    tb = _bf(torch.tensor(taps, dtype=_F32)).numpy()
    out = torch.empty_like(a)
    lib = _lib()
    plan = blur_plan(B, ny, nx, cs_y, cs_x, a.shape[1], len(tb))
    rc = lib.crf_blur_launch(
        a.data_ptr(), gn.data_ptr(), out.data_ptr(), tb.ctypes.data,
        len(tb), B, ny, nx, cs_y, cs_x, a.shape[1], plan.ty, plan.lg,
        plan.threads, plan.smem, _stream(a))
    _ok(lib, rc, "gaussian_blur_planes")
    gaussian_blur_planes.launches += 1
    return out


def gaussian_blur_y_planes(a, gn, *, taps, B: int, ny: int, nx: int,
                           cs_y: int, cs_x: int):
    """Same arguments as :func:`gaussian_blur_y_planes_reference`; the
    kernel takes bf16 ``a``, any cell geometry and a radius within one cell
    (at most 128)."""
    _on_cuda(a, "gaussian_blur_y_planes")
    return _blur_y_op(a, gn, _floats(taps), B, ny, nx, cs_y, cs_x)


def _blur_y_cuda(a, gn, taps, B, ny, nx, cs_y, cs_x):
    per_image = _blur_geometry(a, gn, taps, B, ny, nx, cs_y, cs_x,
                               MAX_YX_TAPS)
    tb = _bf(torch.tensor(taps, dtype=_F32)).numpy()
    out = torch.empty_like(a)
    lib = _lib()
    plan = pass_plan(B, ny, nx, cs_y, cs_x, a.shape[1], len(tb), True)
    rc = lib.crf_blur_y_launch(
        a.data_ptr(), gn.data_ptr(), per_image, out.data_ptr(),
        tb.ctypes.data, len(tb), B, ny, nx, cs_y, cs_x, a.shape[1], plan.ty,
        plan.lg, plan.threads, plan.smem, _stream(a))
    _ok(lib, rc, "gaussian_blur_y_planes")
    gaussian_blur_y_planes.launches += 1
    return out


def gaussian_blur_x_planes(f, *, taps, B: int, ny: int, nx: int, cs_y: int,
                           cs_x: int):
    """Same arguments as :func:`gaussian_blur_x_planes_reference`; the
    kernel takes bf16 ``f``."""
    _on_cuda(f, "gaussian_blur_x_planes")
    return _blur_x_op(f, _floats(taps), B, ny, nx, cs_y, cs_x)


def _blur_x_cuda(f, taps, B, ny, nx, cs_y, cs_x):
    _blur_geometry(f, None, taps, B, ny, nx, cs_y, cs_x, MAX_YX_TAPS)
    tb = _bf(torch.tensor(taps, dtype=_F32)).numpy()
    out = torch.empty_like(f)
    lib = _lib()
    plan = pass_plan(B, ny, nx, cs_y, cs_x, f.shape[1], len(tb), False)
    rc = lib.crf_blur_x_launch(
        f.data_ptr(), out.data_ptr(), tb.ctypes.data, len(tb), B, ny, nx,
        cs_y, cs_x, f.shape[1], plan.ty, plan.lg, plan.threads, plan.smem,
        _stream(f))
    _ok(lib, rc, "gaussian_blur_x_planes")
    gaussian_blur_x_planes.launches += 1
    return out


def mf_step_planes(attrs, grid, f_gauss, q, unary=None, *, nc: int, L: int,
                   inv_step: float, ctaps, cg: float, cb: float,
                   n_energy: float = 0.0, p_energy: float = 0.0,
                   sub_stride: int = 1, cs_y: int = 0, cs_x: int = 0):
    """Same arguments as :func:`mf_step_planes_reference`.  The kernels'
    form is :func:`step_plan`'s (:func:`mf_step_with_plan`)."""
    _on_cuda(attrs, "mf_step_planes")
    return tuple(_mf_step_op(attrs, grid, f_gauss, q, unary, nc, L, inv_step,
                             _floats(ctaps), cg, cb, n_energy, p_energy,
                             sub_stride, cs_y, cs_x))


def mf_step_with_plan(plan, attrs, grid, f_gauss, q, unary=None, *, nc: int,
                      L: int, inv_step: float, ctaps, cg: float, cb: float,
                      n_energy: float = 0.0, p_energy: float = 0.0,
                      sub_stride: int = 1, cs_y: int = 0, cs_x: int = 0):
    """Launch the step's kernels on CUDA tensors in the form ``plan`` (a
    :class:`StepPlan`) names, whether or not :func:`step_plan` would choose
    it; each launch counts in ``mf_step_planes.launches``.  A CPU tensor
    runs the plain version."""
    return tuple(_mf_step_plan_op(
        attrs, grid, f_gauss, q, unary, nc, L, inv_step, _floats(ctaps), cg,
        cb, n_energy, p_energy, sub_stride, cs_y, cs_x, plan.fused, plan.lb,
        plan.splits, plan.lp, plan.smem))


def _mf_step_cuda(attrs, grid, f_gauss, q, unary, nc, L, inv_step, ctaps,
                  cg, cb, n_energy, p_energy, sub_stride, cs_y, cs_x):
    plan = step_plan(attrs.shape[0], attrs.shape[2], nc, L)
    return _mf_step_launch(plan, attrs, grid, f_gauss, q, unary, nc, L,
                           inv_step, ctaps, cg, cb, n_energy, p_energy,
                           sub_stride, cs_y, cs_x)


def _mf_step_launch(plan, attrs, grid, f_gauss, q, unary, nc, L, inv_step,
                    ctaps, cg, cb, n_energy, p_energy, sub_stride, cs_y,
                    cs_x):
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
    if unary is not None:
        _check("unary", unary, (Z, L, P), (_BF16,), dev)
    pack = _color_taps_host(tuple(ctaps))
    out = torch.empty_like(q)
    sub = None
    if sub_stride > 1:
        sub = torch.empty((Z, L, P // (sub_stride * sub_stride)),
                          dtype=_BF16, device=dev)
    scratch = None
    if not plan.fused:
        scratch = torch.empty((Z, nc * C, plan.lp), dtype=_BF16, device=dev)
    lib = _lib()
    rc = lib.crf_mf_step_launch(
        attrs.data_ptr(), grid.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        f_gauss.data_ptr(), q.data_ptr(), out.data_ptr(),
        sub.data_ptr() if sub is not None else None,
        unary.data_ptr() if unary is not None else None,
        pack.ctypes.data, len(ctaps), Z, P, L, nc, max(sub_stride, 1),
        cs_x, int(plan.fused), plan.lb, plan.splits, plan.lp, plan.smem,
        inv_step, cg, cb, n_energy, p_energy, _stream(attrs))
    _ok(lib, rc, "mf_step_planes")
    mf_step_planes.launches += 1
    return [out] if sub is None else [out, sub]


def slice_planes(rgb, grid, *, nc: int, L: int, inv_step: float, ctaps):
    """Same arguments as :func:`slice_planes_reference`; one kernel in
    :func:`slice_plan`'s geometry."""
    _on_cuda(rgb, "slice_planes")
    return _slice_op(rgb, grid, nc, L, inv_step, _floats(ctaps))


def _slice_cuda(rgb, grid, nc, L, inv_step, ctaps):
    Z, _, P = rgb.shape
    dev = rgb.device
    _check_grid(nc, inv_step, L)
    C, D = nc * nc, nc * L
    _check("rgb", rgb, (Z, 3, P), (_F32,), dev)
    _check("grid", grid, (Z, D, C), (_F32,), dev)
    pack = _color_taps_host(tuple(ctaps))
    out = torch.empty((Z, L, P), dtype=_F32, device=dev)
    plan = slice_plan(Z, P, L, nc)
    lib = _lib()
    rc = lib.crf_slice_launch(
        rgb.data_ptr(), grid.data_ptr(), out.data_ptr(), pack.ctypes.data,
        len(ctaps), Z, P, L, nc, inv_step, plan.lg, plan.lb, plan.lgp,
        int(plan.pad), plan.splits, plan.smem, _stream(rgb))
    _ok(lib, rc, "slice_planes")
    slice_planes.launches += 1
    return out


splat_planes.launches = 0
slice_attrs_planes.launches = 0
gaussian_blur_planes.launches = 0
gaussian_blur_y_planes.launches = 0
gaussian_blur_x_planes.launches = 0
mf_step_planes.launches = 0
slice_planes.launches = 0


# ------------------------------------------------------------ operators ----
# Each launch above as a ``deeplab_tpu_torch::`` operator (kernels/ops.py):
# the CUDA implementation launches, the CPU one runs the plain version, the
# fake one gives the outputs' shapes and dtypes from the inputs' alone.

def _contiguous(outs):
    return [t.contiguous() for t in outs]


def _slice_attrs_fake(rgb, grid, gn, labels, nc, L, inv_step, ctaps, stride,
                      cs_y, cs_x, h, w, nx, Z, gt_prob):
    BZ, _, P = rgb.shape
    outs = [rgb.new_empty((BZ, ATTR_ROWS, P), dtype=_F32),
            rgb.new_empty((BZ, L, P), dtype=_BF16)]
    if stride > 1:
        Ps = P // (stride * stride)
        outs += [rgb.new_empty((BZ, ATTR_ROWS, Ps), dtype=_F32),
                 rgb.new_empty((BZ, L, Ps), dtype=_BF16)]
    return outs


def _mf_step_fake(attrs, grid, f_gauss, q, unary, nc, L, inv_step, ctaps,
                  cg, cb, n_energy, p_energy, sub_stride, cs_y, cs_x, *plan):
    Z, _, P = q.shape
    outs = [torch.empty_like(q)]
    if sub_stride > 1:
        outs.append(q.new_empty((Z, L, P // (sub_stride * sub_stride))))
    return outs


def _mf_step_cpu(attrs, grid, f_gauss, q, unary, nc, L, inv_step, ctaps, cg,
                 cb, n_energy, p_energy, sub_stride, cs_y, cs_x, *plan):
    return _contiguous(mf_step_planes_reference(
        attrs, grid, f_gauss, q, unary, nc=nc, L=L, inv_step=inv_step,
        ctaps=ctaps, cg=cg, cb=cb, n_energy=n_energy, p_energy=p_energy,
        sub_stride=sub_stride, cs_y=cs_y, cs_x=cs_x))


def _mf_step_plan_cuda(attrs, grid, f_gauss, q, unary, nc, L, inv_step,
                       ctaps, cg, cb, n_energy, p_energy, sub_stride, cs_y,
                       cs_x, fused, lb, splits, lp, smem):
    return _mf_step_launch(StepPlan(fused, lb, splits, lp, smem), attrs,
                           grid, f_gauss, q, unary, nc, L, inv_step, ctaps,
                           cg, cb, n_energy, p_energy, sub_stride, cs_y, cs_x)


_BLUR_ARGS = "float[] taps, SymInt B, int ny, int nx, int cs_y, int cs_x"
_STEP_ARGS = ("Tensor attrs, Tensor grid, Tensor f_gauss, Tensor q, "
              "Tensor? unary, int nc, int L, float inv_step, float[] ctaps, "
              "float cg, float cb, float n_energy, float p_energy, "
              "int sub_stride, int cs_y, int cs_x")


def _blur_kw(taps, B, ny, nx, cs_y, cs_x):
    return dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)


_splat_op = OPS.define(
    "splat_planes(Tensor rgb, Tensor values, int nc, int L, float inv_step, "
    "ScalarType out_dtype) -> Tensor",
    cuda=_splat_cuda,
    cpu=lambda rgb, values, nc, L, inv_step, out_dtype:
        splat_planes_reference(rgb, values, nc=nc, L=L, inv_step=inv_step,
                               out_dtype=out_dtype).contiguous(),
    fake=lambda rgb, values, nc, L, inv_step, out_dtype: rgb.new_empty(
        (rgb.shape[0], nc * L, nc * nc), dtype=out_dtype))
_slice_attrs_op = OPS.define(
    "slice_attrs_planes(Tensor rgb, Tensor grid, Tensor gn, Tensor labels, "
    "int nc, int L, float inv_step, float[] ctaps, int stride, int cs_y, "
    "int cs_x, int h, int w, int nx, int Z, float gt_prob) -> Tensor[]",
    cuda=_slice_attrs_cuda,
    cpu=lambda rgb, grid, gn, labels, nc, L, inv_step, ctaps, stride, cs_y,
    cs_x, h, w, nx, Z, gt_prob: _contiguous(slice_attrs_planes_reference(
        rgb, grid, gn, labels, nc=nc, L=L, inv_step=inv_step, ctaps=ctaps,
        stride=stride, cs_y=cs_y, cs_x=cs_x, h=h, w=w, nx=nx, Z=Z,
        gt_prob=gt_prob)),
    fake=_slice_attrs_fake)
_blur_rows_op = OPS.define(
    f"blur_rows(Tensor a, Tensor gn, {_BLUR_ARGS}) -> Tensor",
    cuda=_blur_rows_cuda,
    cpu=lambda a, gn, *geo: gaussian_blur_planes_reference(
        a, gn, **_blur_kw(*geo)).contiguous(),
    fake=lambda a, gn, *geo: torch.empty_like(a))
_blur_y_op = OPS.define(
    f"gaussian_blur_y_planes(Tensor a, Tensor gn, {_BLUR_ARGS}) -> Tensor",
    cuda=_blur_y_cuda,
    cpu=lambda a, gn, *geo: gaussian_blur_y_planes_reference(
        a, gn, **_blur_kw(*geo)).contiguous(),
    fake=lambda a, gn, *geo: torch.empty_like(a))
_blur_x_op = OPS.define(
    f"gaussian_blur_x_planes(Tensor f, {_BLUR_ARGS}) -> Tensor",
    cuda=_blur_x_cuda,
    cpu=lambda f, *geo: gaussian_blur_x_planes_reference(
        f, **_blur_kw(*geo)).contiguous(),
    fake=lambda f, *geo: torch.empty_like(f))
_mf_step_op = OPS.define(
    f"mf_step_planes({_STEP_ARGS}) -> Tensor[]",
    cuda=_mf_step_cuda, cpu=_mf_step_cpu, fake=_mf_step_fake)
_mf_step_plan_op = OPS.define(
    f"mf_step_with_plan({_STEP_ARGS}, bool fused, int lb, int splits, "
    f"int lp, int smem) -> Tensor[]",
    cuda=_mf_step_plan_cuda, cpu=_mf_step_cpu, fake=_mf_step_fake)
_slice_op = OPS.define(
    "slice_planes(Tensor rgb, Tensor grid, int nc, int L, float inv_step, "
    "float[] ctaps) -> Tensor",
    cuda=_slice_cuda,
    cpu=lambda rgb, grid, nc, L, inv_step, ctaps: slice_planes_reference(
        rgb, grid, nc=nc, L=L, inv_step=inv_step, ctaps=ctaps).contiguous(),
    fake=lambda rgb, grid, nc, L, inv_step, ctaps: rgb.new_empty(
        (rgb.shape[0], L, rgb.shape[2]), dtype=_F32))


# ---------------------------------------- kernels against plain versions ----

@contextlib.contextmanager
def plain_versions(names=KERNELS):
    """Within the block each wrapper named (by default the plane engine's;
    ``XLA_KERNELS`` for the XLA engine's) runs its plain version, on any
    device, and records the call: yields {name: [(args, kw, out)]} in call
    order.  The launch counts do not move."""
    mod = sys.modules[__name__]
    calls = {n: [] for n in names}
    saved = {n: getattr(mod, n) for n in names}

    def recorder(name):
        ref = getattr(mod, name + "_reference")

        def call(*args, **kw):
            out = ref(*args, **kw)
            calls[name].append((args, kw, out))
            return out
        return call
    for n in names:
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
        elif name == "slice_planes":
            pairs = [(g, w, PLAIN_BF16_REL)]
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
