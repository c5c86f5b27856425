"""Fused eval-mode layers of the two trunks, each one CUDA kernel:

- the inverted-residual (MBConv) block: 1x1 expand -> relu6 -> 3x3 dilated
  depthwise -> relu6 -> 1x1 project [+ residual].  Replaces the TPU kernel
  ``deeplab_tpu/kernels/fused_mbconv.py::fused_mbconv`` (its
  ``pl.pallas_call`` at line 121); source ``csrc/fused_mbconv.cu``.
- the stride-1 SepConv_BN of the Xception net: [relu] -> 3x3 dilated
  depthwise -> [relu] -> 1x1 pointwise -> [relu], BN folded into both.
  Replaces ``fused_mbconv.py::fused_sepconv`` (``pl.pallas_call`` at line
  208); source ``csrc/fused_sepconv.cu``.

Each source's header says what bounds it on the H100 and how the design deals
with that.  ``fused_mbconv_reference`` and ``fused_sepconv_reference`` are the
plain PyTorch versions of the same functions: the CPU path and the yardstick
for the kernels on the card.

Precision, as in the TPU kernel: under ``mxu_bf16`` (the "mixed" policy) x and
the output are float32 and the two matmuls take bf16 operands; under bf16
everything the matmuls touch is bf16.  Both accumulate in f32, the depthwise
taps run in f32 in every mode, and the residual is added in f32 before the
output cast.  The kernels take those two modes; the float32 policy keeps the
plain layer composition, as in the JAX package.  The SepConv kernel rounds
its f32 depthwise result to the matmul dtype before the pointwise, as the
TPU kernel does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from deeplab_tpu_torch.kernels import ops as OPS
from deeplab_tpu_torch.ops.bn import bn_scale_shift

_SIGS = {"fused_mbconv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15
         + [ctypes.c_void_p],
         "fused_sepconv": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 18
         + [ctypes.c_void_p]}


def _lib(name: str = "fused_mbconv"):
    from deeplab_tpu_torch.kernels import build
    lib = build.load(name)
    launch = getattr(lib, name + "_launch")
    if launch.argtypes is None:
        launch.argtypes = _SIGS[name]
        launch.restype = ctypes.c_int
        err = getattr(lib, name + "_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _check_weights(x, shapes):
    """Raise unless each ``name: (tensor, shape, dtype)`` matches and every
    tensor is contiguous on ``x``'s device."""
    for name, (t, shp, dt) in shapes.items():
        if tuple(t.shape) != shp or t.dtype != dt:
            raise ValueError(f"{name}: want {shp} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in [("x", x)] + [(n, v[0]) for n, v in shapes.items()]:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


# Launch geometry of csrc/fused_mbconv.cu, decided here and checked there.
SMEM_LIMIT = 232448          # dynamic shared memory a block may use (H100)
SM_COUNT = 132
MBCONV_WARPS = 16            # 512 threads, at most 128 registers each
# output tiles (TH, TW); each warp projects one m-tile of 16 of a tile's
# TH*TW pixels, and the 16 // (TH*TW/16) warps of an m-tile split Cout
MBCONV_TILES = ((16, 16), (8, 16), (8, 8))
MBCONV_CHUNKS = (32, 16)     # expanded channels per pipeline stage
# project n-tiles (8 output channels) per warp that the source instantiates,
# by pixels per tile: an accumulator of 16 x 8 NT f32 per warp
MBCONV_NT = {64: (2, 4, 10), 128: (2, 4, 6, 10), 256: (2, 4, 8, 12)}
# the cost model: clocks a block spends per chunk, fitted to the times of
# every (tile, chunk) at the main path's shapes on an H100
# (``chip_smoke.py --plan-sweep``): a fixed part (barriers, copies, loop),
# per round of the expand's 32-pixel units per 16-deep k-step, per depthwise
# channel pair a thread, per project mma.sync a warp
_CLK_CHUNK, _CLK_EXPAND, _CLK_DW, _CLK_PROJ = 2150.0, 97.0, 1060.0, 84.0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _a16(n: int) -> int:
    return _ceil(n, 16) * 16


def _a1024(n: int) -> int:
    return _ceil(n, 1024) * 1024


@dataclasses.dataclass(frozen=True)
class MbconvPlan:
    """One ``fused_mbconv`` launch: a block per (TH x TW output tile, image),
    expanded channels in chunks of ``ck`` through a ring of ``stages``
    weight buffers, ``nt`` project n-tiles per warp, ``smem`` bytes of
    dynamic shared memory, and the grid ``(tiles_y * tiles_x, B)``."""
    th: int
    tw: int
    ck: int
    stages: int
    nt: int
    smem: int
    tiles_y: int
    tiles_x: int
    B: int
    halo: float      # expanded pixels per output pixel, over the whole map
    est_clk: float   # the cost model's estimate (clocks), for the choice

    @property
    def grid(self):
        return (self.tiles_y * self.tiles_x, self.B)


def mbconv_smem(H, W, Cin, Cout, rate, th, tw, ck, stages) -> int:
    """Dynamic shared memory of one block, in the layout of
    csrc/fused_mbconv.cu (``smem_layout``): the x tile and the f32 expanded
    chunk over the tile's in-image halo box, the bf16 depthwise output of
    the tile, the depthwise's tap table, and ``stages`` weight buffers
    (w1, b1, w2, wdw, bdw)."""
    cin_p = _a16(Cin)
    rows = _a16(min(th + 2 * rate, H) * min(tw + 2 * rate, W))
    # x rows of 4 (mod 8) 16-byte chunks are swizzled, others padded
    xs_ld = cin_p if (cin_p // 8) % 8 == 4 else cin_p + 8
    w2_ld = Cout + (8 if (Cout // 8) % 2 == 0 else 16)
    stage = (_a16(2 * cin_p * ck) + _a16(4 * ck) + _a16(2 * ck * w2_ld)
             + _a16(4 * 9 * ck) + _a16(4 * ck))
    return (_a16(2 * rows * xs_ld) + _a16(4 * (rows + 1) * ck)
            + _a16(2 * th * tw * (ck + 8)) + _a16(2 * 9 * th * tw)
            + stages * stage)


def _axis_boxes(n: int, t: int, r: int):
    """In-image halo extent of each tile along one axis of length n."""
    return [min(i + t + r, n) - max(i - r, 0) for i in range(0, n, t)]


def mbconv_halo(H, W, th, tw, rate) -> float:
    """Expanded pixels per output pixel: each tile expands its in-image halo
    box, rounded up to whole m-tiles of 16 pixels."""
    ys, xs = _axis_boxes(H, th, rate), _axis_boxes(W, tw, rate)
    return sum(_a16(y * x) for y in ys for x in xs) / (H * W)


@functools.lru_cache(maxsize=256)
def mbconv_plan(B, H, W, Cin, Ce, Cout, rate) -> MbconvPlan:
    """Choose the tile, chunk and ring depth of a launch.  Among the tiles
    and chunks whose shared memory fits and whose accumulator the source
    instantiates, take the least estimated time: whole waves of blocks over
    the 132 SMs, times the chunks, times the cost model's clocks per chunk
    (the expand's rounds over the warps at the largest halo box, the
    depthwise and the project per thread).  Then three weight stages where
    they fit, else two."""
    best = None
    ksteps = _ceil(Cin, 16)
    for th, tw in MBCONV_TILES:
        tp = th * tw
        wn = MBCONV_WARPS * 16 // tp
        need = _ceil(Cout // 8, wn)
        nts = [n for n in MBCONV_NT[tp] if n >= need]
        if not nts:
            continue
        ty, tx = _ceil(H, th), _ceil(W, tw)
        boxes = max(y * x for y in _axis_boxes(H, th, rate)
                    for x in _axis_boxes(W, tw, rate))
        for ck in MBCONV_CHUNKS:
            if mbconv_smem(H, W, Cin, Cout, rate, th, tw, ck, 2) > SMEM_LIMIT:
                continue
            units = _ceil(_ceil(boxes, 16), 2) * (ck // 16)
            clk = (_CLK_CHUNK + _CLK_EXPAND * _ceil(units, MBCONV_WARPS)
                   * ksteps + _CLK_DW * tp * ck / (2 * 32 * MBCONV_WARPS)
                   + _CLK_PROJ * nts[0] * ck / 16)
            est = math.ceil(B * ty * tx / SM_COUNT) * _ceil(Ce, ck) * clk
            if best is None or est < best[0]:
                best = (est, th, tw, ck, nts[0], ty, tx)
    if best is None:
        raise ValueError(f"no fused_mbconv tile fits Cin={Cin} Cout={Cout} "
                         f"rate={rate}")
    est, th, tw, ck, nt, ty, tx = best
    stages = 3 if mbconv_smem(H, W, Cin, Cout, rate, th, tw, ck,
                              3) <= SMEM_LIMIT else 2
    return MbconvPlan(th, tw, ck, stages, nt,
                      mbconv_smem(H, W, Cin, Cout, rate, th, tw, ck, stages),
                      ty, tx, B, mbconv_halo(H, W, th, tw, rate), est)


# Launch geometry of csrc/fused_sepconv.cu, decided here and checked there.
SEPCONV_WARPS = 8            # 256 threads: two warpgroups
# the output tile, 8 x 8 pixels: wgmma's 64 rows; each warpgroup multiplies
# them by N = 16 NT output channels a pass
SEPCONV_TILE = 8
SEPCONV_CHUNKS = (64, 32, 16)  # input channels per pipeline stage
SEPCONV_NT = (4, 8)          # a pass: 32 NT output channels
# blocks an SM holds by registers: the NT = 4 instantiations are built for
# two (at most 128 registers a thread), the NT = 8 ones for one
SEPCONV_BLOCKS_PER_SM = {4: 2, 8: 1}
_ST_PAD = 8                  # staging row padding (elements)
# the cost model, clocks a block spends: a fixed part, per barrier
# interval, per (pixel, input channel) of depthwise, per tensor-core flop
# and per byte brought from L2 (the x box, wpw), fitted by least squares
# to the times of every chunk, pass width and group count at the Xception
# shapes on an H100 (``chip_smoke.py --sepconv-plan-sweep``; PERF.md)
_SC_FIXED, _SC_INTERVAL, _SC_DW = 6975.0, 1066.0, 0.4529
_SC_FLOP, _SC_L2 = 4.327e-4, 0.0262
# a second block on an SM stretches each block's time by this share of
# its own (the rest overlaps the other's waits); fitted with the above
_SC_SHARE = 0.3


def _sep_bands(n: int, t0: int, t: int, r: int):
    """The in-image reach of a tile's taps along one axis of length n: the
    union of [t0 + k r, t0 + k r + t), k = -1, 0, 1, clipped to [0, n), as
    (lo, length) bands in order -- one span where r <= t, else three
    disjoint bands (``bands_of`` in csrc/fused_sepconv.cu)."""
    spans = ([(t0 - r, t0 + t + r)] if r <= t else
             [(t0 + k * r, t0 + k * r + t) for k in (-1, 0, 1)])
    out = []
    for lo, hi in spans:
        lo, hi = max(lo, 0), min(hi, n)
        out.append((lo, max(hi - lo, 0)))
    return out


def _sep_extents(n: int, t: int, r: int):
    """The box extent of each tile along one axis."""
    return [sum(ln for _, ln in _sep_bands(n, t0, t, r))
            for t0 in range(0, n, t)]


def sepconv_box(H, W, th, tw, rate) -> int:
    """Pixels of the largest in-image halo box over the map's tiles."""
    return max(_sep_extents(H, th, rate)) * max(_sep_extents(W, tw, rate))


def sepconv_halo(H, W, th, tw, rate) -> float:
    """Box pixels staged per output pixel, over the whole map."""
    return (sum(_sep_extents(H, th, rate)) * sum(_sep_extents(W, tw, rate))
            / (H * W))


def sepconv_np(nt) -> int:
    """Output channels a pass: two warpgroups of 16 NT."""
    return 32 * nt


@dataclasses.dataclass(frozen=True)
class SepconvPlan:
    """One ``fused_sepconv`` launch: a block per (TH x TW output tile,
    image, group of ``cg`` output channels), Cin in chunks of ``ck``
    through rings of ``stages`` slots (x boxes, wpw k-slices), passes of
    ``np_`` output channels with ``nt`` n-tiles a warp, the
    depthwise held in ``a_slots`` chunk slots (all of Cin where a block
    takes more than one pass), ``smem`` bytes of dynamic shared memory, and
    the grid ``(tiles_y * tiles_x * groups, B)``."""
    th: int
    tw: int
    ck: int
    stages: int
    nt: int
    groups: int
    cg: int
    np_: int
    a_slots: int
    smem: int
    tiles_y: int
    tiles_x: int
    B: int
    halo: float      # box pixels staged per output pixel, over the map
    est_clk: float   # the cost model's estimate (clocks), for the choice

    @property
    def grid(self):
        return (self.tiles_y * self.tiles_x * self.groups, self.B)

    @property
    def passes(self) -> int:
        return _ceil(self.cg, self.np_)


def sepconv_smem(H, W, Cin, Cout, rate, th, tw, ck, stages, nt, cg,
                 esz) -> int:
    """Dynamic shared memory of one block, in the layout of
    csrc/fused_sepconv.cu (``smem_layout``): the tap table, the box's
    pixels, the depthwise's A chunk slots, the x ring of ``stages`` (each
    the box plus a zero row, then the chunk's taps and bias) which the
    warps' output staging reuses, and the wpw ring of ``stages`` k-slices;
    A and the wpw ring start on 1024-byte lines (wgmma's swizzle).
    ``esz``: bytes of an x element (4 under "mixed", 2 under bf16)."""
    M, NP = th * tw, sepconv_np(nt)
    rows = sepconv_box(H, W, th, tw, rate)
    n_chunks = _ceil(Cin, ck)
    a_slots = n_chunks if _ceil(cg, NP) > 1 else 2
    xstage = _a16((rows + 1) * ck * esz) + _a16(4 * 10 * ck)
    staging = SEPCONV_WARPS * 16 * (nt * 8 + _ST_PAD) * esz
    o = _a1024(_a16(4 * 9 * M) + _a16(4 * rows))    # A: wgmma's swizzle
    o = _a1024(o + _a16(2 * a_slots * M * ck) + _a16(max(stages * xstage,
                                                         staging)))
    return o + stages * 2 * ck * NP


def _sep_rings(H, W, Cin, Cout, rate, th, tw, ck, nt, cg, esz):
    """(stages, smem): three stages where they fit, else two; None when
    not even two fit."""
    smem = lambda stages: sepconv_smem(H, W, Cin, Cout, rate, th, tw, ck,
                                       stages, nt, cg, esz)
    if smem(2) > SMEM_LIMIT:
        return None
    stages = 3 if smem(3) <= SMEM_LIMIT else 2
    return stages, smem(stages)


@functools.lru_cache(maxsize=256)
def sepconv_plan(B, H, W, Cin, Cout, rate, bf16: bool = False) -> SepconvPlan:
    """Choose the chunk, pass width, Cout groups and ring depth of a
    launch.  Among the choices whose shared memory fits, take the least
    estimated time: whole waves of the blocks an SM holds (by shared
    memory and registers), times the cost model's clocks a block (a fixed
    part, the barrier intervals, the depthwise, the pointwise's
    tensor-core work and its bytes from L2).  Three ring stages where they
    fit, else two."""
    if Cin % 8 or Cout % 8 or rate < 1:
        raise ValueError(f"fused_sepconv: unsupported shape Cin={Cin} "
                         f"Cout={Cout} rate={rate}")
    esz = 2 if bf16 else 4
    best = None
    th = tw = SEPCONV_TILE
    M = th * tw
    ty, tx = _ceil(H, th), _ceil(W, tw)
    halo_px = sepconv_halo(H, W, th, tw, rate) * M
    for ck in SEPCONV_CHUNKS:
        n_chunks = _ceil(Cin, ck)
        for nt in SEPCONV_NT:
            NP = sepconv_np(nt)
            for G in range(1, _ceil(Cout, 64) + 1):
                cg = _ceil(_ceil(Cout, G), 8) * 8
                if (G - 1) * cg >= Cout:
                    continue
                rings = _sep_rings(H, W, Cin, Cout, rate, th, tw, ck, nt, cg,
                                   esz)
                if rings is None:
                    continue
                per_sm = max(1, min(SEPCONV_BLOCKS_PER_SM[nt],
                                    (SMEM_LIMIT + 1024) // (rings[1] + 1024)))
                passes = _ceil(cg, NP)
                clk = (_SC_FIXED
                       + _SC_INTERVAL * (passes * n_chunks + 1)
                       + _SC_DW * M * Cin
                       + _SC_FLOP * 2 * M * Cin * cg
                       + _SC_L2 * (halo_px * Cin * esz + 2 * Cin * cg))
                est = (math.ceil(B * ty * tx * G / (SM_COUNT * per_sm))
                       * (1 + _SC_SHARE * (per_sm - 1)) * clk)
                if best is None or est < best[0]:
                    best = (est, ck, nt, G, cg, rings)
    if best is None:
        raise ValueError(f"fused_sepconv: no tile fits Cin={Cin} "
                         f"Cout={Cout} rate={rate} at {H}x{W}")
    est, ck, nt, G, cg, (stages, smem) = best
    NP = sepconv_np(nt)
    return SepconvPlan(th, tw, ck, stages, nt, G, cg, NP,
                       _ceil(Cin, ck) if _ceil(cg, NP) > 1 else 2, smem,
                       ty, tx, B, sepconv_halo(H, W, th, tw, rate), est)


def fused_mbconv_reference(x, w1, b1, wdw, bdw, w2, b2, *, rate: int,
                           skip: bool, mxu_bf16: bool = False):
    """Plain PyTorch twin of the kernel.  x: (B, H, W, Cin) f32 or bf16;
    w1 (Cin, Ce); wdw (9, Ce) f32 taps, (dy, dx) row-major; w2 (Ce, Cout);
    b1, bdw (Ce,) and b2 (Cout,) f32 with BN folded."""
    B, H, W, _ = x.shape
    mm_dt = torch.bfloat16 if mxu_bf16 else x.dtype
    # bf16 x bf16 products are exact in f32, so an f32 product of the
    # bf16-rounded operands is the f32-accumulated bf16 matmul
    e = x.to(mm_dt).float() @ w1.to(mm_dt).float() + b1.float()
    e = torch.clamp(e, 0.0, 6.0)
    # SAME zero padding acts on the depthwise INPUT e (not on x)
    r = rate
    ep = F.pad(e, (0, 0, r, r, r, r))
    acc = bdw.float().expand_as(e)
    for j in range(3):            # dx outer, dy inner: the kernels' order
        for i in range(3):
            acc = acc + (ep[:, i * r:i * r + H, j * r:j * r + W, :]
                         * wdw[i * 3 + j].float())
    y = torch.clamp(acc, 0.0, 6.0).to(mm_dt)
    o = y.float() @ w2.to(mm_dt).float() + b2.float()
    if skip:
        o = o + x.float()
    return o.to(x.dtype)


def fused_mbconv(x, w1, b1, wdw, bdw, w2, b2, *, rate: int, skip: bool,
                 mxu_bf16: bool = False):
    """Same arguments as :func:`fused_mbconv_reference`.  A CUDA tensor runs
    the kernel (or raises); a CPU tensor runs the plain version.  One call
    is one ``deeplab_tpu_torch::fused_mbconv`` operator."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mbconv runs on cuda or cpu, not {x.device}")
    return _fused_mbconv_op(x, w1, b1, wdw, bdw, w2, b2, rate, skip,
                            mxu_bf16)


def _fused_mbconv_cuda(x, w1, b1, wdw, bdw, w2, b2, rate, skip, mxu_bf16):
    """The operator's CUDA implementation: check, plan and launch."""
    B, H, W, Cin = x.shape
    Ce, Cout = w1.shape[1], w2.shape[1]
    if x.dtype == torch.float32 and not mxu_bf16:
        raise ValueError("fused_mbconv takes f32 input only under mxu_bf16; "
                         "the float32 policy keeps the plain composition")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported input dtype {x.dtype}")
    if skip and Cout != Cin:
        raise ValueError(f"skip needs Cout == Cin, got {Cin} -> {Cout}")
    if Cout % 8 or Cout > 320 or rate not in (1, 2, 4):
        raise ValueError(f"unsupported shape Cout={Cout}, rate={rate}")
    _check_weights(x, {"w1": (w1, (Cin, Ce), torch.bfloat16),
                       "b1": (b1, (Ce,), torch.float32),
                       "wdw": (wdw, (9, Ce), torch.float32),
                       "bdw": (bdw, (Ce,), torch.float32),
                       "w2": (w2, (Ce, Cout), torch.bfloat16),
                       "b2": (b2, (Cout,), torch.float32)})
    for name, t in (("w2", w2), ("b1", b1), ("bdw", bdw)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies it by 16-byte vectors)")
    plan = mbconv_plan(B, H, W, Cin, Ce, Cout, rate)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_mbconv_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wdw.data_ptr(),
        bdw.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        B, H, W, Cin, Ce, Cout, rate, int(skip),
        int(x.dtype == torch.bfloat16), plan.th, plan.tw, plan.ck,
        plan.stages, plan.nt, plan.smem, stream)
    if rc != 0:
        raise RuntimeError("fused_mbconv launch failed: "
                           + lib.fused_mbconv_error(rc).decode())
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0
_fused_mbconv_op = OPS.define(
    "fused_mbconv(Tensor x, Tensor w1, Tensor b1, Tensor wdw, Tensor bdw, "
    "Tensor w2, Tensor b2, int rate, bool skip, bool mxu_bf16) -> Tensor",
    cuda=_fused_mbconv_cuda,
    cpu=lambda x, w1, b1, wdw, bdw, w2, b2, rate, skip, mxu_bf16:
        fused_mbconv_reference(x, w1, b1, wdw, bdw, w2, b2, rate=rate,
                               skip=skip, mxu_bf16=mxu_bf16).contiguous(),
    fake=lambda x, w1, b1, wdw, bdw, w2, b2, rate, skip, mxu_bf16:
        x.new_empty(tuple(x.shape[:3]) + (w2.shape[1],)))


def fold_block(net, prefix: str, policy):
    """The kernel's weights for block ``prefix`` of ``net``: its three eval
    BNs folded into the convs, as deeplab_tpu's ``_fold_bn`` does.  Returns
    ``(w1, b1, wdw, bdw, w2, b2)`` and the ``mxu_bf16`` flag."""
    s1, t1 = bn_scale_shift(getattr(net, prefix + "expand_BN"))
    sd, td = bn_scale_shift(getattr(net, prefix + "depthwise_BN"))
    s2, t2 = bn_scale_shift(getattr(net, prefix + "project_BN"))
    k1 = getattr(net, prefix + "expand").kernel[:, :, 0, 0]      # (Ce, Cin)
    kd = getattr(net, prefix + "depthwise").depthwise_kernel     # (Ce,1,3,3)
    k2 = getattr(net, prefix + "project").kernel[:, :, 0, 0]     # (Cout, Ce)
    dt = policy.dtype
    mxu = policy.mxu_bf16 and dt == torch.float32
    wdt = torch.bfloat16 if mxu else dt
    w1 = (k1.float().t() * s1).to(wdt).contiguous()
    wdw = (kd.float().reshape(kd.shape[0], 9).t() * sd).contiguous()
    w2 = (k2.float().t() * s2).to(wdt).contiguous()
    return (w1, t1.contiguous(), wdw, td.contiguous(), w2,
            t2.contiguous()), mxu


def fused_block_apply(net, x, prefix: str, rate: int, skip: bool, policy):
    """Run one inverted-residual block (expand present, stride 1, eval mode)
    through :func:`fused_mbconv` (deeplab_tpu's ``fused_block_apply``).
    ``x`` is NCHW; the result is NCHW in channels-last memory."""
    weights, mxu = fold_block(net, prefix, policy)
    xh = x.permute(0, 2, 3, 1).to(policy.dtype).contiguous()
    out = fused_mbconv(xh, *weights, rate=rate, skip=skip, mxu_bf16=mxu)
    return out.permute(0, 3, 1, 2)


def fused_sepconv_reference(x, wdw, bdw, wpw, bpw, *, rate: int,
                            pre_relu: bool, act_mid: bool, act_out: bool,
                            mxu_bf16: bool = False):
    """Plain PyTorch twin of the SepConv kernel.  x: (B, H, W, Cin) f32 or
    bf16; wdw (9, Cin) f32 taps, (dy, dx) row-major; wpw (Cin, Cout); bdw
    (Cin,) and bpw (Cout,) f32 with BN folded.  Stride 1, SAME zero padding
    of the (ReLU'd) input at any ``rate``."""
    B, H, W, _ = x.shape
    mm_dt = torch.bfloat16 if mxu_bf16 else x.dtype
    xf = x.float()
    if pre_relu:
        xf = torch.relu(xf)
    r = rate
    xp = F.pad(xf, (0, 0, r, r, r, r))
    acc = bdw.float().expand_as(xf)
    for j in range(3):            # dx outer, dy inner: the kernels' order
        for i in range(3):
            acc = acc + (xp[:, i * r:i * r + H, j * r:j * r + W, :]
                         * wdw[i * 3 + j].float())
    if act_mid:
        acc = torch.relu(acc)
    o = acc.to(mm_dt).float() @ wpw.to(mm_dt).float() + bpw.float()
    if act_out:
        o = torch.relu(o)
    return o.to(x.dtype)


def fused_sepconv(x, wdw, bdw, wpw, bpw, *, rate: int, pre_relu: bool,
                  act_mid: bool, act_out: bool, mxu_bf16: bool = False):
    """Same arguments as :func:`fused_sepconv_reference`.  A CUDA tensor
    runs the kernel (or raises); a CPU tensor runs the plain version.  One
    call is one ``deeplab_tpu_torch::fused_sepconv`` operator."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_sepconv runs on cuda or cpu, not {x.device}")
    return _fused_sepconv_op(x, wdw, bdw, wpw, bpw, rate, pre_relu, act_mid,
                             act_out, mxu_bf16)


def _fused_sepconv_cuda(x, wdw, bdw, wpw, bpw, rate, pre_relu, act_mid,
                        act_out, mxu_bf16):
    """The operator's CUDA implementation: check, plan and launch."""
    B, H, W, Cin = x.shape
    Cout = wpw.shape[1]
    if x.dtype == torch.float32 and not mxu_bf16:
        raise ValueError("fused_sepconv takes f32 input only under mxu_bf16; "
                         "the float32 policy keeps the plain composition")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported input dtype {x.dtype}")
    if Cin % 8 or Cout % 8 or rate < 1:
        raise ValueError(f"unsupported shape Cin={Cin}, Cout={Cout}, "
                         f"rate={rate}")
    _check_weights(x, {"wdw": (wdw, (9, Cin), torch.float32),
                       "bdw": (bdw, (Cin,), torch.float32),
                       "wpw": (wpw, (Cin, Cout), torch.bfloat16),
                       "bpw": (bpw, (Cout,), torch.float32)})
    for name, t in (("x", x), ("wdw", wdw), ("bdw", bdw), ("wpw", wpw)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies it by 16-byte vectors)")
    bf16 = x.dtype == torch.bfloat16
    plan = sepconv_plan(B, H, W, Cin, Cout, rate, bf16)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    # the kernel reads wpw's k-slices n-major (the tensor cores' K-major B)
    wpw_t = wpw.t().contiguous()
    lib = _lib("fused_sepconv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_sepconv_launch(
        x.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), wpw_t.data_ptr(),
        bpw.data_ptr(), out.data_ptr(), B, H, W, Cin, Cout, rate,
        int(pre_relu), int(act_mid), int(act_out), int(bf16), plan.th,
        plan.tw, plan.ck, plan.stages, plan.nt, plan.groups, plan.cg,
        plan.smem, stream)
    if rc != 0:
        raise RuntimeError("fused_sepconv launch failed: "
                           + lib.fused_sepconv_error(rc).decode())
    fused_sepconv.launches += 1
    return out


fused_sepconv.launches = 0
_fused_sepconv_op = OPS.define(
    "fused_sepconv(Tensor x, Tensor wdw, Tensor bdw, Tensor wpw, Tensor bpw, "
    "int rate, bool pre_relu, bool act_mid, bool act_out, bool mxu_bf16) "
    "-> Tensor",
    cuda=_fused_sepconv_cuda,
    cpu=lambda x, wdw, bdw, wpw, bpw, rate, pre_relu, act_mid, act_out,
    mxu_bf16: fused_sepconv_reference(
        x, wdw, bdw, wpw, bpw, rate=rate, pre_relu=pre_relu,
        act_mid=act_mid, act_out=act_out, mxu_bf16=mxu_bf16).contiguous(),
    fake=lambda x, wdw, bdw, wpw, bpw, rate, pre_relu, act_mid, act_out,
    mxu_bf16: x.new_empty(tuple(x.shape[:3]) + (wpw.shape[1],)))


def fold_sepconv(net, prefix: str, policy):
    """The kernel's weights for SepConv_BN ``prefix`` of ``net``: its two
    eval BNs (each with its own eps) folded into the depthwise taps and the
    pointwise, as deeplab_tpu's ``fused_sepconv_apply`` does.  Returns
    ``(wdw, bdw, wpw, bpw)`` and the ``mxu_bf16`` flag."""
    sd, td = bn_scale_shift(getattr(net, prefix + "_depthwise_BN"))
    sp, tp = bn_scale_shift(getattr(net, prefix + "_pointwise_BN"))
    kd = getattr(net, prefix + "_depthwise").depthwise_kernel   # (Cin,1,3,3)
    kp = getattr(net, prefix + "_pointwise").kernel[:, :, 0, 0]  # (Cout, Cin)
    dt = policy.dtype
    mxu = policy.mxu_bf16 and dt == torch.float32
    wdw = (kd.float().reshape(kd.shape[0], 9).t() * sd).contiguous()
    wpw = (kp.float().t() * sp).to(torch.bfloat16 if mxu else dt)
    return (wdw, td.contiguous(), wpw.contiguous(), tp.contiguous()), mxu


def fused_sepconv_apply(net, x, prefix: str, rate: int,
                        depth_activation: bool, policy):
    """Run one stride-1 SepConv_BN (eval mode) through
    :func:`fused_sepconv` (deeplab_tpu's ``fused_sepconv_apply``): ReLU
    first without ``depth_activation``, after each BN with it.  ``x`` is
    NCHW; the result is NCHW in channels-last memory."""
    weights, mxu = fold_sepconv(net, prefix, policy)
    xh = x.permute(0, 2, 3, 1).to(policy.dtype).contiguous()
    out = fused_sepconv(xh, *weights, rate=rate,
                        pre_relu=not depth_activation,
                        act_mid=depth_activation, act_out=depth_activation,
                        mxu_bf16=mxu)
    return out.permute(0, 3, 1, 2)
