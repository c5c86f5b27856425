"""Training-mode inverted-residual (MBConv) block: forward and backward in five
CUDA phase kernels, each beside its plain PyTorch version.

Replaces the TPU kernel ``deeplab_tpu/kernels/fused_mbconv_train.py::
block_train`` and its five ``pl.pallas_call`` phases:

- ``f1``  (``_run_f1``, line 254): batch sum and sum of squares of the
  expand output ``eq = q(x @ w1)``;
- ``f2``  (``_run_f2``, line 302): the depthwise output ``dq`` (saved) and its
  sums, recomputing ``aq = relu6(q(q(eq*a1) + c1))`` on a halo;
- ``f3``  (``_run_f3``, line 345): the raw project output ``y_raw``;
- ``b2``  (``_run_b2``, line 404): the depthwise-BN grad sums T1/T2, ``dW2``,
  and ``ddh = (q(gy) @ w2^T) * relu6'(v2)``;
- ``b34`` (``_run_b34``, line 535): the expand-BN grad sums U1/U2, the tap
  gradient ``dWdw``, the main part of ``dx`` and ``dW1^T``.

The CUDA source is ``csrc/fused_mbconv_train.cu``; its header says what bounds
each phase on the H100 and how the design deals with it.  One design choice
differs from the TPU's: ``b2`` saves ``ddh`` (f32, pixels x Ce) for ``b34``,
which then needs neither ``g`` nor ``y_raw`` nor a second product with
``w2`` on its halo.  The plain versions (``*_reference``) have the same
interface.  A CPU tensor runs the plain version; a CUDA tensor runs the
kernel (bf16 only, as the JAX gate engages only under bf16) or raises.

Rounding, as in the TPU kernel (``q`` rounds to the compute dtype): ``eq``,
the BN affines ``q(q(v*a) + c)``, ``dq`` and ``y_raw`` are rounded; matmul
operands are rounded to the compute dtype and accumulate in f32; taps,
statistics, BN grad sums and weight gradients are f32; relu6' masks are
strict (``0 < v < 6``).  The glue between the phases (statistics finalize,
affines, the epilogue ``y_raw*a3 + c3 (+x)``, the project-BN sums S1/S2 and
the analytic BN1 mean-term corrections) is plain torch, as it is XLA on the
TPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import sys

import torch
import torch.nn.functional as F

from deeplab_tpu_torch.kernels.fused_mbconv import (SM_COUNT, SMEM_LIMIT,
                                                    _a16, _axis_boxes, _ceil)
from deeplab_tpu_torch.kernels.fused_mbconv import mbconv_halo as train_halo

PHASES = ("f1", "f2", "f3", "b2", "b34")
# the TPU kernels they replace: deeplab_tpu/kernels/fused_mbconv_train.py
REPLACES = {"f1": 254, "f2": 302, "f3": 345, "b2": 404, "b34": 535}
EPS = 1e-3
# A phase kernel against its plain version on the same inputs, relative to
# the largest magnitude of each output: both take the same bf16 operands,
# whose products are exact in f32, and differ in summation order.  bf16
# outputs (dq, y_raw, dx) may round the other way: 2 bf16 ulps.  f32 sums,
# ddh and weight gradients differ by f32 rounding: 1e-3.  Beyond that, a
# recomputed expand value whose bf16 rounding flips can flip a relu6' mask
# (the JAX kernel's docstring measured the same between any two builds),
# which moves the elements it feeds by about one term: at most
# max(1, FLIP_SHARE * size) elements of an output may exceed the tolerance,
# and none FLIP_REL of its largest magnitude.
PLAIN_BF16_REL, PLAIN_F32_REL = 2.0 ** -7, 1e-3
FLIP_SHARE, FLIP_REL = 1e-3, 0.05

_PHASE_ID = {n: i for i, n in enumerate(PHASES)}

# ---------------------------------------------------------------------------
# launch plan of the halo phases F2 and B34 (csrc/fused_mbconv_train.cu
# checks it and never recomputes it differently)
# ---------------------------------------------------------------------------

TRAIN_WARPS = 16             # F2 and B34: 512 threads, at most 128 registers
# output tiles (TH, TW) and expanded channels per chunk the plan may choose
TRAIN_TILES = ((16, 16), (8, 16), (8, 8))
TRAIN_CHUNKS = (32, 16)
# B34's second and third kernels, dx = dvl @ w1^T and dW1^T = dvl^T x: 8
# warps a block, two m-tiles and one half of Cin (NT n-tiles) a warp, rings
# of 3.  dx: 128 pixels a block, Ce in chunks of DX_K; dW1^T: 128 expanded
# channels a block, 64 pixels a k-step
WG_WARPS, WG_M, WG_GP, WG_STAGES = 8, 128, 64, 3
DX_WARPS, DX_M, DX_K, DX_STAGES = 8, 128, 64, 3
WG_NT = (2, 4, 6, 10)
TAB_LD = 16                  # tap-table entries a pixel (9 used)
# the cost model, clocks a block spends per chunk: a fixed part (barriers,
# copies, loop), per round of the expand's 32-pixel units per 16-deep
# k-step, per tap pass of a channel pair a thread (F2's 9 taps; B34's 18
# and its elementwise terms count 2.5), and per halo value of dd converted
# a thread
_CLK_CHUNK, _CLK_EXPAND, _CLK_TAPS, _CLK_DD = 2150.0, 97.0, 1060.0, 60.0


def _box_rows(H, W, th, tw, rate) -> int:
    """Rows of the largest in-image halo box, in whole m-tiles of 16."""
    return _a16(min(th + 2 * rate, H) * min(tw + 2 * rate, W))


def _xs_ld(Cin) -> int:
    """Row stride (bf16) of the x tile: rows of 4 (mod 8) 16-byte chunks are
    swizzled, others padded by one chunk."""
    cin_p = _a16(Cin)
    return cin_p if (cin_p // 8) % 8 == 4 else cin_p + 8


def train_smem(phase, H, W, Cin, rate, th, tw, ck, stages) -> int:
    """Dynamic shared memory of one F2 or B34 block, in the layout of
    csrc/fused_mbconv_train.cu (``lay_halo``).  Both: the x tile over the
    in-image halo box, the expanded activation aq of a chunk (bf16, plus a
    zero row), the tap table, the per-warp sums, and ``stages`` buffers of
    one chunk's w1 slice, taps and per-channel vectors.  B34 adds dd (f32,
    plus a zero row) with dq's raw rows, eq at the tile's pixels, and the
    box-row-to-pixel table."""
    cin_p, tp = _a16(Cin), th * tw
    rows = _box_rows(H, W, th, tw, rate)
    common = (_a16(2 * rows * _xs_ld(Cin)) + _a16(2 * (rows + 1) * ck)
              + _a16(2 * TAB_LD * tp))
    if phase == "f2":
        stage = _a16(2 * cin_p * ck) + 2 * _a16(4 * ck) + _a16(4 * 9 * ck)
        return (common + _a16(4 * 2 * TRAIN_WARPS * ck) + stages * stage)
    stage = _a16(2 * cin_p * ck) + _a16(4 * 9 * ck) + 7 * _a16(4 * ck)
    return (common + _a16(4 * (rows + 1) * ck) + _a16(2 * rows * ck)
            + _a16(2 * tp * ck) + _a16(2 * rows)
            + _a16(4 * 11 * TRAIN_WARPS * ck) + stages * stage)


def tap_offset_fits(H, W, th, tw, rate, ck) -> bool:
    """The tap table holds word offsets into aq as 16-bit integers."""
    return (_box_rows(H, W, th, tw, rate) + 1) * (ck // 2) <= 32767


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """One F2 or B34 launch: a block of ``warps`` warps per (TH x TW output
    tile, image), expanded channels in chunks of ``ck`` through a ring of
    ``stages`` buffers, ``smem`` bytes of dynamic shared memory, the grid
    ``(tiles_y * tiles_x, B)``; B34 also its dx and dW1^T kernels' ``nt``
    n-tiles a warp, dW1^T over ``splits`` pixel splits.  B2, F1 and F3
    use the fields their planners document (F3: ``th`` pixels a block,
    ``tw`` column groups, ``nt`` n-tiles a warpgroup, ``splits`` of
    Cout); their ``est_clk`` is 0, since no cost model chooses them."""
    phase: str
    th: int
    tw: int
    ck: int
    stages: int
    nt: int
    smem: int
    tiles_y: int
    tiles_x: int
    B: int
    warps: int
    splits: int
    halo: float      # expanded pixels per output pixel, over the whole map
    est_clk: float   # the cost model's estimate (clocks), for the choice

    @property
    def grid(self):
        return (self.tiles_y * self.tiles_x, self.B)

    @property
    def fields(self):
        """What the launcher takes after the shape: (th, tw, ck, stages, nt,
        smem, warps, splits)."""
        return (self.th, self.tw, self.ck, self.stages, self.nt, self.smem,
                self.warps, self.splits)


def wg_smem(Cin) -> int:
    """Dynamic shared memory of one dW1^T block: WG_STAGES buffers of a
    64-pixel group's dvl (128 channels) and x rows."""
    return WG_STAGES * (_a16(2 * WG_GP * WG_M) + _a16(2 * WG_GP * _xs_ld(Cin)))


def dx_smem(Cin) -> int:
    """Dynamic shared memory of one dx block: DX_STAGES buffers of 128
    pixels' dvl and of w1's rows (Cin padded to 16), DX_K channels each."""
    return DX_STAGES * (2 * DX_M * DX_K + 2 * _a16(Cin) * DX_K)


# B2 (``b2_kernel``): 16 warps a block (at most 128 registers a thread), a
# chunk of CEB expanded channels and every splits-th group of B2_GP pixels;
# dW2's accumulator is one channel m-tile x NT2 n-tiles a warp over
# 16 / (CEB / 16) warp columns, and the source instantiates these NT2 per
# CEB
B2_WARPS, B2_GP = 16, 64
B2_NT = {128: (2, 4, 6, 10), 64: (1, 2, 3, 5, 10)}
# the cost model, clocks a block spends per group: a fixed part (two
# barriers, the loop), per tensor-core flop (both products) and per byte
# moved (gyq and dq in, ddh out)
_B2_CLK_GROUP, _B2_CLK_FLOP, _B2_CLK_BYTE = 1200.0, 1 / 2048, 1 / 32


def b2_smem(Cout, ceb, stages) -> int:
    """Dynamic shared memory of one B2 block, in the layout of
    csrc/fused_mbconv_train.cu (``lay_b2``): the chunk's w2 rows (Cout
    padded to 16, plus 8), its four per-channel vectors, the group's ddh
    staging (f32) and q(b) (bf16) tiles, the warps' T1/T2 sums, and
    ``stages`` buffers of a group's gyq and dq rows."""
    gld, dld = _a16(Cout) + 8, ceb + 8
    stage = _a16(2 * B2_GP * gld) + _a16(2 * B2_GP * dld)
    return (_a16(2 * ceb * gld) + _a16(16 * ceb) + _a16(4 * B2_GP * dld)
            + _a16(2 * B2_GP * dld) + _a16(32 * ceb) + stages * stage)


def _b2_plan(B, H, W, Ce, Cout) -> TrainPlan:
    """B2's chunk, accumulator, ring and splits: among the chunks whose dW2
    accumulator the source instantiates and whose shared memory fits, the
    least estimated time (whole waves of one block an SM, times a block's
    groups, times the cost model's clocks a group); then three stages
    where they fit, and splits for one wave."""
    if Ce % 8 or Cout % 8 or Cout > 320:
        raise ValueError(f"b2: unsupported shape Ce={Ce} Cout={Cout}")
    groups = _ceil(B * H * W, B2_GP)
    best = None
    for ceb, nts in B2_NT.items():
        need = _ceil(Cout // 8, B2_WARPS // (ceb // 16))
        fit = [n for n in nts if n >= need]
        if not fit or b2_smem(Cout, ceb, 2) > SMEM_LIMIT:
            continue
        stages = 3 if b2_smem(Cout, ceb, 3) <= SMEM_LIMIT else 2
        smem = b2_smem(Cout, ceb, stages)
        n_chunks = _ceil(Ce, ceb)
        splits = max(1, min(groups, SM_COUNT // n_chunks))
        cout_k = _a16(Cout)
        clk = (_B2_CLK_GROUP + _B2_CLK_FLOP * 4 * B2_GP * ceb * cout_k
               + _B2_CLK_BYTE * B2_GP * (2 * cout_k + 6 * ceb))
        est = (math.ceil(n_chunks * splits / SM_COUNT)
               * _ceil(groups, splits) * clk)
        if best is None or est < best[0]:
            best = (est, ceb, stages, fit[0], smem, splits)
    if best is None:
        raise ValueError(f"b2: no chunk fits Ce={Ce} Cout={Cout}")
    est, ceb, stages, nt, smem, splits = best
    return TrainPlan("b2", 0, 0, ceb, stages, nt, smem, 0, 0, B, B2_WARPS,
                     splits, 1.0, est)


# F1 (``f1_kernel``): a block of one, two or four warpgroups (64 expanded
# channels each) per (chunk of Ce, pixel split), its w1 slice resident,
# 64-pixel x tiles through a ring of F1_STAGES (two tiles' products may be
# in flight); the product on wgmma m64n64k16.  The plan takes four
# warpgroups where Cin (padded to 32) is 128 or more, two where it is 64
# or more, else one (the sweep of ``chip_smoke.py --train-plan-sweep``:
# more warpgroups read each x tile for more channels, one fills the card
# at the narrow blocks), and splits for one wave (the blocks an SM holds,
# times the SMs).  The ring of 4 fits at every Cin the kernel takes (at
# most 168 KB at Cin 160, four warpgroups).
F1_GP, F1_KP = 64, 32
F1_WGS = (1, 2, 4)
F1_STAGES = 4


def f1_smem(Cin, wgs) -> int:
    """Dynamic shared memory of one F1 block, in the layout of
    csrc/fused_mbconv_train.cu (``lay_f1``): the chunk's w1^T (64 wgs rows
    of Cin padded to 32), F1_STAGES x tiles (64 rows), the warps' sums."""
    kp = _ceil(Cin, F1_KP) * F1_KP
    nb = 64 * wgs
    return 2 * nb * kp + F1_STAGES * 2 * F1_GP * kp + 32 * nb


def _blocks_per_sm(smem, threads, regs=128) -> int:
    """Blocks an SM holds by shared memory (1 KB reserved a block) and by
    registers (``regs`` a thread)."""
    by_smem = (SMEM_LIMIT + 1024) // (smem + 1024)
    return max(1, min(by_smem, 65536 // (threads * regs)))


def _f1_plan(B, H, W, Cin, Ce) -> TrainPlan:
    """F1's warpgroups a block and splits (see F1_WGS)."""
    if Cin % 8 or Ce % 8 or Cin > 160:
        raise ValueError(f"f1: unsupported shape Cin={Cin} Ce={Ce}")
    kp = _ceil(Cin, F1_KP) * F1_KP
    tiles = _ceil(B * H * W, F1_GP)
    want = 4 if kp >= 128 else 2 if kp >= 64 else 1
    wgs = max([w for w in F1_WGS if w <= want] or [min(F1_WGS)])
    smem = f1_smem(Cin, wgs)
    n_chunks = _ceil(Ce, 64 * wgs)
    per_sm = _blocks_per_sm(smem, 128 * wgs)
    splits = max(1, min(tiles, 65535, per_sm * SM_COUNT // n_chunks))
    return TrainPlan("f1", 0, 0, 64 * wgs, F1_STAGES, 0, smem, 0, 0, B,
                     4 * wgs, splits, 1.0, 0.0)


# F3 (``f3_kernel``): a block of 2 x CW warpgroups per (F3_PM = 128 pixels,
# split of Cout into CW groups of N = 8 NT columns), Ce in chunks of F3_CK
# through a ring of F3_STAGES, the product on wgmma m64nNk16.  F3_CASES
# are the (NT, CW) the source instantiates: 32 to 160 columns in one
# group, 128 to 320 in two (four warpgroups: w2 read once per 128 pixels
# at Cout 320).  The plan takes the fewest splits of Cout, then the fewest
# columns past Cout, then one column group, then the least N: every case
# is the choice at some Cout.  Then the deepest ring of at most 3 that
# leaves room for two blocks an SM, or, where the registers hold one block
# an SM, the deepest ring that fits (the sweep of ``chip_smoke.py
# --train-plan-sweep``).
F3_PM, F3_CK = 128, 64
F3_CASES = ((4, 1), (8, 1), (12, 1), (20, 1), (8, 2), (12, 2), (20, 2))
F3_STAGES = (4, 3, 2)


def _f3_cols(nt, cw) -> int:
    """Output channels of one F3 block."""
    return 8 * nt * cw


def f3_smem(Ce, nt, cw, stages) -> int:
    """Dynamic shared memory of one F3 block, in the layout of
    csrc/fused_mbconv_train.cu (``lay_f3``): a2 and c2 over whole chunks,
    f32 and bf16 (to a whole KB), then ``stages`` buffers of a chunk's dq
    rows (F3_PM x 64) and w2^T rows (the block's columns x 64)."""
    vec = _ceil(12 * _ceil(Ce, F3_CK) * F3_CK, 1024) * 1024
    return vec + stages * 2 * F3_CK * (F3_PM + _f3_cols(nt, cw))


def _f3_plan(B, H, W, Ce, Cout) -> TrainPlan:
    """F3's columns a block, Cout split and ring (see F3_CASES)."""
    if Ce % 8 or Cout % 8 or Cout > 320:
        raise ValueError(f"f3: unsupported shape Ce={Ce} Cout={Cout}")

    def key(case):
        nt, cw = case
        splits = _ceil(Cout, _f3_cols(nt, cw))
        return (splits, splits * _f3_cols(nt, cw) - Cout, cw, nt)
    nt, cw = min(F3_CASES, key=key)
    splits = _ceil(Cout, _f3_cols(nt, cw))
    threads = 256 * cw
    fit = [st for st in F3_STAGES if f3_smem(Ce, nt, cw, st) <= SMEM_LIMIT]
    if not fit:
        raise ValueError(f"f3: no ring fits Ce={Ce} Cout={Cout}")
    # the source's launch bounds: blocks of one column group of N <= 96
    # keep to 128 registers (two blocks an SM), the rest one block
    two_by_regs = cw == 1 and 8 * nt <= 96
    two = [st for st in fit if st <= 3 and two_by_regs and _blocks_per_sm(
        f3_smem(Ce, nt, cw, st), threads) >= 2]
    stages = max(two or fit)
    return TrainPlan("f3", F3_PM, cw, F3_CK, stages, nt,
                     f3_smem(Ce, nt, cw, stages), 0, 0, B, threads // 32,
                     splits, 1.0, 0.0)


@functools.lru_cache(maxsize=512)
def train_plan(phase, B, H, W, Cin, Ce, Cout, rate) -> TrainPlan:
    """Choose the tile, chunk and ring depth of an F2 or B34 launch.  Among
    the tiles and chunks whose shared memory fits, take the least estimated
    time: whole waves of one block per SM, times the chunks, times the cost
    model's clocks per chunk.  Then three stages where they fit, else two.
    B34's dx and dW1^T kernels hold half of Cin a warp; dW1^T runs over
    pixel splits for about two blocks per SM.  B2's plan (chunk of Ce,
    dW2 accumulator, ring, splits) is ``_b2_plan``'s, F1's (warpgroups,
    splits) ``_f1_plan``'s and F3's (columns, Cout split, ring)
    ``_f3_plan``'s; B2 and F3 ignore Cin and rate, F1 Cout and rate."""
    if phase == "b2":
        return _b2_plan(B, H, W, Ce, Cout)
    if phase == "f1":
        return _f1_plan(B, H, W, Cin, Ce)
    if phase == "f3":
        return _f3_plan(B, H, W, Ce, Cout)
    if phase not in ("f2", "b34"):
        raise ValueError(f"no launch plan for phase {phase!r}")
    if Cin % 8 or Ce % 8 or Cin > 160 or rate < 1:
        raise ValueError(f"{phase}: unsupported shape Cin={Cin} Ce={Ce} "
                         f"rate={rate}")
    best = None
    ksteps = _ceil(Cin, 16)
    for th, tw in TRAIN_TILES:
        tp = th * tw
        ty, tx = _ceil(H, th), _ceil(W, tw)
        boxes = max(y * x for y in _axis_boxes(H, th, rate)
                    for x in _axis_boxes(W, tw, rate))
        for ck in TRAIN_CHUNKS:
            if (train_smem(phase, H, W, Cin, rate, th, tw, ck, 2) > SMEM_LIMIT
                    or not tap_offset_fits(H, W, th, tw, rate, ck)):
                continue
            units = _ceil(_ceil(boxes, 16), 2) * (ck // 16)
            taps = tp * ck / (2 * 32 * TRAIN_WARPS)
            clk = (_CLK_CHUNK + _CLK_EXPAND * _ceil(units, TRAIN_WARPS)
                   * ksteps)
            if phase == "f2":
                clk += _CLK_TAPS * taps
            else:
                clk += (2.5 * _CLK_TAPS * taps
                        + _CLK_DD * boxes * ck / (32 * TRAIN_WARPS))
            est = math.ceil(B * ty * tx / SM_COUNT) * _ceil(Ce, ck) * clk
            if best is None or est < best[0]:
                best = (est, th, tw, ck, ty, tx)
    if best is None:
        raise ValueError(f"{phase}: no tile fits Cin={Cin} rate={rate} at "
                         f"{H}x{W}")
    est, th, tw, ck, ty, tx = best
    stages = 3 if train_smem(phase, H, W, Cin, rate, th, tw, ck,
                             3) <= SMEM_LIMIT else 2
    nt = splits = 0
    if phase == "b34":
        nt = min(n for n in WG_NT if 2 * n * 8 >= Cin)
        m_blocks = _ceil(Ce, WG_M)
        groups = _ceil(B * H * W, WG_GP)
        splits = max(1, min(groups, _ceil(2 * SM_COUNT, m_blocks)))
    return TrainPlan(phase, th, tw, ck, stages, nt,
                     train_smem(phase, H, W, Cin, rate, th, tw, ck, stages),
                     ty, tx, B, TRAIN_WARPS, splits,
                     train_halo(H, W, th, tw, rate), est)


_SIG = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]


def _lib():
    from deeplab_tpu_torch.kernels import build
    lib = build.load("fused_mbconv_train")
    if lib.mbt_launch.argtypes is None:
        lib.mbt_launch.argtypes = _SIG
        lib.mbt_launch.restype = ctypes.c_int
        lib.mbt_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.mbt_scratch_bytes.restype = ctypes.c_longlong
        lib.mbt_error.argtypes = [ctypes.c_int]
        lib.mbt_error.restype = ctypes.c_char_p
    return lib


def _q(dt):
    if dt == torch.bfloat16:
        return lambda v: v.to(torch.bfloat16).float()
    return lambda v: v


def _mm(a, b, dt):
    """f32-accumulated product of operands rounded to ``dt``: bf16 x bf16
    products are exact in f32, so an f32 product of the rounded operands is
    the tensor-core product up to summation order."""
    return a.to(dt).float() @ b.to(dt).float()


def _relu6(v):
    return torch.clamp(v, 0.0, 6.0)


def _mask(v):
    return ((v > 0.0) & (v < 6.0)).float()


def _pad(t, r):
    """Zero-pad the H and W dims of an NHWC tensor by ``r``."""
    return F.pad(t, (0, 0, r, r, r, r))


def _expand(x, w1, a1, c1):
    """(aq, eq, v1) of the expand stage, each (B, H, W, Ce) f32 holding
    dt-rounded values."""
    dt = x.dtype
    q = _q(dt)
    B, H, W, Cin = x.shape
    eq = q(_mm(x.reshape(-1, Cin), w1, dt)).reshape(B, H, W, -1)
    v1 = q(q(eq * a1) + c1)
    return _relu6(v1), eq, v1


# ---------------------------------------------------------------------------
# plain versions of the five phases
# ---------------------------------------------------------------------------

def f1_reference(x, w1):
    """x (B, H, W, Cin), w1 (Cin, Ce) in the compute dtype -> (s, ss), the
    per-channel sum and sum of squares of eq = q(x @ w1), f32 (Ce,)."""
    dt = x.dtype
    eq = _q(dt)(_mm(x.reshape(-1, x.shape[-1]), w1, dt))
    return eq.sum(0), (eq * eq).sum(0)


def f2_reference(x, w1, a1, c1, wdw, *, rate: int):
    """-> (s, ss, dq): dq = q(depthwise(aq)) (B, H, W, Ce) in the compute
    dtype, SAME zero padding of aq, the 9 dilated taps ``wdw`` (9, Ce) f32
    summed dx outer, dy inner; s, ss its f32 sums."""
    dt = x.dtype
    aq, _, _ = _expand(x, w1, a1, c1)
    H, W = x.shape[1], x.shape[2]
    r = rate
    ap = _pad(aq, r)
    d = torch.zeros_like(aq)
    for j in range(3):
        for i in range(3):
            d = d + ap[:, i * r:i * r + H, j * r:j * r + W, :] * wdw[i * 3 + j]
    dq = _q(dt)(d)
    flat = dq.reshape(-1, dq.shape[-1])
    return flat.sum(0), (flat * flat).sum(0), dq.to(dt)


def f3_reference(dq, a2, c2, w2):
    """-> y_raw = q(relu6(q(q(dq*a2) + c2)) @ w2), (B, H, W, Cout)."""
    dt = dq.dtype
    q = _q(dt)
    B, H, W, Ce = dq.shape
    b = _relu6(q(q(dq.float() * a2) + c2)).reshape(-1, Ce)
    # a contiguous w2: the product's order does not follow w2's layout
    return _mm(b, w2.contiguous(), dt).to(dt).reshape(B, H, W, -1)


def b2_reference(dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1):
    """-> (t1, t2, dw2, ddh).  gy = gA3*g + k0 + k1*y_raw is dL/dy_raw;
    ddh = (q(gy) @ w2^T) * relu6'(v2) (B, H, W, Ce) f32; t1 = sum ddh,
    t2 = sum ddh*dhat (Ce,); dw2 = sum q(b) (x) q(gy) (Ce, Cout) f32."""
    dt = dq.dtype
    q = _q(dt)
    B, H, W, Ce = dq.shape
    dqf = dq.float().reshape(-1, Ce)
    v2 = q(q(dqf * a2) + c2)
    dhat = (dqf - mu2) * rstd2
    gy = (gA3 * g.float().reshape(-1, g.shape[-1]) + k0
          + k1 * y.float().reshape(-1, y.shape[-1]))
    ddh = _mm(gy, w2.t(), dt) * _mask(v2)
    dw2 = _mm(_relu6(v2).t(), gy, dt)
    return (ddh.sum(0), (ddh * dhat).sum(0), dw2,
            ddh.reshape(B, H, W, Ce))


def b34_reference(x, dq, ddh, w1, a1, c1, wdw, a2, m0, m1, mu1, rstd1, *,
                  rate: int):
    """-> (u1, u2, dwdw, dxp, dw1t).  dd = a2*ddh + m0 + m1*dq is dL/d(dw
    output) (zero outside the image); da = transposed taps of dd; dv1 =
    da * relu6'(v1); u1 = sum dv1, u2 = sum dv1*ehat (Ce,); dwdw (9, Ce) =
    sum dd (x) aq shifted by each tap; dxp = q(q(a1*dv1) @ w1^T) (B, H, W,
    Cin) in the compute dtype; dw1t = sum q(a1*dv1) (x) x (Ce, Cin) f32."""
    dt = x.dtype
    B, H, W, Cin = x.shape
    Ce = w1.shape[1]
    r = rate
    aq, eq, v1 = _expand(x, w1, a1, c1)
    dd = a2 * ddh + m0 + m1 * dq.float()
    dp, ap = _pad(dd, r), _pad(aq, r)
    da = torch.zeros_like(dd)
    dwdw = []
    for j in range(3):
        for i in range(3):
            da = da + (dp[:, (2 - i) * r:(2 - i) * r + H,
                          (2 - j) * r:(2 - j) * r + W, :] * wdw[i * 3 + j])
    for i in range(3):
        for j in range(3):
            dwdw.append((dd * ap[:, i * r:i * r + H, j * r:j * r + W, :])
                        .reshape(-1, Ce).sum(0))
    dv1 = (da * _mask(v1)).reshape(-1, Ce)
    ehat = ((eq - mu1) * rstd1).reshape(-1, Ce)
    dvl = a1 * dv1
    dxp = _mm(dvl, w1.t(), dt).to(dt).reshape(B, H, W, Cin)
    dw1t = _mm(dvl.t(), x.reshape(-1, Cin), dt)
    return dv1.sum(0), (dv1 * ehat).sum(0), torch.stack(dwdw), dxp, dw1t


# ---------------------------------------------------------------------------
# kernel wrappers: a CUDA tensor launches the phase's kernel or raises
# ---------------------------------------------------------------------------

def _dims(B, H, W, Cin, Ce, Cout, rate, plan):
    """The launcher's dims: the shape, then the phase's plan
    (``TrainPlan.fields``)."""
    return (ctypes.c_int * 15)(B, H, W, Cin, Ce, Cout, rate, *plan.fields)


def _launch(name: str, tensors, dims):
    """Check the operands (device, contiguity; dtypes by the caller) and
    launch phase ``name`` on the current stream with its scratch."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} must be contiguous on {dev}")
    lib = _lib()
    pid = _PHASE_ID[name]
    nbytes = lib.mbt_scratch_bytes(pid, dims)
    if nbytes < 0:
        raise ValueError(f"{name}: unsupported shape {list(dims)}")
    ptrs = [t.data_ptr() for t in tensors]
    if nbytes:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        ptrs.append(scratch.data_ptr())
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    rc = lib.mbt_launch(pid, arr, len(ptrs), dims,
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mbconv_train {name} launch failed: "
                           + lib.mbt_error(rc).decode())


def _check(name, x, specs):
    """``specs``: (label, tensor, shape, dtype).  Raises on the first
    operand the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 activations, not "
                         f"{x.dtype} (the float32 policy keeps the plain "
                         f"layer composition)")
    for label, t, shape, dt in specs:
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise ValueError(f"{name}: {label} wants {tuple(shape)} {dt}, "
                             f"got {tuple(t.shape)} {t.dtype}")


_F32, _BF16 = torch.float32, torch.bfloat16


def f1(x, w1):
    if x.device.type == "cpu":
        return f1_reference(x, w1)
    B, H, W, Cin = x.shape
    Ce = w1.shape[1]
    _check("f1", x, [("w1", w1, (Cin, Ce), _BF16)])
    out = torch.empty((2, Ce), dtype=_F32, device=x.device)
    plan = train_plan("f1", B, H, W, Cin, Ce, 8, 1)
    _launch("f1", [x, w1, out], _dims(B, H, W, Cin, Ce, 8, 1, plan))
    f1.launches += 1
    return out[0], out[1]


def f2(x, w1, a1, c1, wdw, *, rate: int):
    if x.device.type == "cpu":
        return f2_reference(x, w1, a1, c1, wdw, rate=rate)
    B, H, W, Cin = x.shape
    Ce = w1.shape[1]
    _check("f2", x, [("w1", w1, (Cin, Ce), _BF16), ("a1", a1, (Ce,), _F32),
                     ("c1", c1, (Ce,), _F32), ("wdw", wdw, (9, Ce), _F32)])
    out = torch.empty((2, Ce), dtype=_F32, device=x.device)
    dq = torch.empty((B, H, W, Ce), dtype=x.dtype, device=x.device)
    plan = train_plan("f2", B, H, W, Cin, Ce, 8, rate)
    _launch("f2", [x, w1, a1, c1, wdw, out, dq],
            _dims(B, H, W, Cin, Ce, 8, rate, plan))
    f2.launches += 1
    return out[0], out[1], dq


def f3(dq, a2, c2, w2):
    if dq.device.type == "cpu":
        return f3_reference(dq, a2, c2, w2)
    B, H, W, Ce = dq.shape
    Cout = w2.shape[1]
    _check("f3", dq, [("a2", a2, (Ce,), _F32), ("c2", c2, (Ce,), _F32),
                      ("w2", w2, (Ce, Cout), _BF16)])
    y = torch.empty((B, H, W, Cout), dtype=dq.dtype, device=dq.device)
    plan = train_plan("f3", B, H, W, 8, Ce, Cout, 1)
    # the kernel reads w2^T (Cout x Ce), K-major for wgmma.  The block's w2
    # is the transpose of the project kernel, so that is w2's own memory;
    # any other layout costs one copy, which rounds nothing.
    w2t = w2.t()
    if not w2t.is_contiguous():
        w2t = w2t.contiguous()
    _launch("f3", [dq, a2, c2, w2t, y], _dims(B, H, W, 8, Ce, Cout, 1, plan))
    f3.launches += 1
    return y


def b2(dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1):
    if dq.device.type == "cpu":
        return b2_reference(dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1)
    B, H, W, Ce = dq.shape
    Cout = w2.shape[1]
    vec = lambda n, t, c: (n, t, (c,), _F32)
    _check("b2", dq, [("g", g, (B, H, W, Cout), _BF16),
                      ("y", y, (B, H, W, Cout), _BF16),
                      vec("a2", a2, Ce), vec("c2", c2, Ce),
                      vec("mu2", mu2, Ce), vec("rstd2", rstd2, Ce),
                      ("w2", w2, (Ce, Cout), _BF16), vec("gA3", gA3, Cout),
                      vec("k0", k0, Cout), vec("k1", k1, Cout)])
    t = torch.empty((2, Ce), dtype=_F32, device=dq.device)
    dw2 = torch.empty((Ce, Cout), dtype=_F32, device=dq.device)
    ddh = torch.empty((B, H, W, Ce), dtype=_F32, device=dq.device)
    plan = train_plan("b2", B, H, W, 8, Ce, Cout, 1)
    _launch("b2", [dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1, t, dw2,
                   ddh], _dims(B, H, W, 8, Ce, Cout, 1, plan))
    b2.launches += 1
    return t[0], t[1], dw2, ddh


def b34(x, dq, ddh, w1, a1, c1, wdw, a2, m0, m1, mu1, rstd1, *, rate: int):
    if x.device.type == "cpu":
        return b34_reference(x, dq, ddh, w1, a1, c1, wdw, a2, m0, m1, mu1,
                             rstd1, rate=rate)
    B, H, W, Cin = x.shape
    Ce = w1.shape[1]
    vec = lambda n, t: (n, t, (Ce,), _F32)
    _check("b34", x, [("dq", dq, (B, H, W, Ce), _BF16),
                      ("ddh", ddh, (B, H, W, Ce), _F32),
                      ("w1", w1, (Cin, Ce), _BF16), vec("a1", a1),
                      vec("c1", c1), ("wdw", wdw, (9, Ce), _F32),
                      vec("a2", a2), vec("m0", m0), vec("m1", m1),
                      vec("mu1", mu1), vec("rstd1", rstd1)])
    u = torch.empty((11, Ce), dtype=_F32, device=x.device)
    dxp = torch.empty((B, H, W, Cin), dtype=x.dtype, device=x.device)
    dw1t = torch.empty((Ce, Cin), dtype=_F32, device=x.device)
    plan = train_plan("b34", B, H, W, Cin, Ce, 8, rate)
    _launch("b34", [x, dq, ddh, w1, a1, c1, wdw, a2, m0, m1, mu1, rstd1, u,
                    dxp, dw1t], _dims(B, H, W, Cin, Ce, 8, rate, plan))
    b34.launches += 1
    return u[0], u[1], u[2:], dxp, dw1t


for _fn in (f1, f2, f3, b2, b34):
    _fn.launches = 0


@contextlib.contextmanager
def plain_versions():
    """Within the block every phase runs its plain version, on any device,
    and records the call: yields {phase: [(args, kw, out)]} in call order.
    The launch counts do not move."""
    mod = sys.modules[__name__]
    calls = {n: [] for n in PHASES}
    saved = {n: getattr(mod, n) for n in PHASES}

    def recorder(name):
        ref = getattr(mod, name + "_reference")

        def call(*args, **kw):
            out = ref(*args, **kw)
            calls[name].append((args, kw, out))
            return out
        return call
    for n in PHASES:
        setattr(mod, n, recorder(n))
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(mod, n, f)


def max_err_vs_plain(got, want):
    """A phase's outputs against its plain version's: (largest abs error,
    largest error relative to each output's largest magnitude, whether every
    output is within its ``PLAIN_*_REL`` tolerance but for the isolated
    elements a flipped relu6' mask may move, see ``FLIP_*``)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst_abs, worst_rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        err = diff.max().item()
        scale = max(w.float().abs().max().item(), 1e-30)
        tol = PLAIN_BF16_REL if w.dtype == torch.bfloat16 else PLAIN_F32_REL
        n_out = int((diff > tol * scale).sum().item())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
        ok = ok and (n_out == 0 or (n_out <= max(1, FLIP_SHARE * w.numel())
                                    and err <= FLIP_REL * scale))
    return worst_abs, worst_rel, ok


def boundary_ulps(e64: torch.Tensor) -> torch.Tensor:
    """Distance of each float64 value from its nearest bf16 rounding
    boundary (a value halfway between two neighbouring bf16 values), in f32
    ulps of that boundary."""
    base = e64.float().abs().view(torch.int32) & ~0xFFFF
    best = None
    for step in (-0x10000, 0, 0x10000):
        mb = (base + step) | 0x8000
        m = mb.view(torch.float32).double()
        ulp = (mb + 1).view(torch.float32).double() - m
        d = (e64.abs() - m).abs() / ulp
        best = d if best is None else torch.minimum(best, d)
    return best


def _flipped(name, args, kw, cand):
    """The plain version of halo phase ``name`` with the one eq value at
    ``cand`` (b, y, x, c) rounded to its other bf16 neighbour, the one
    towards its float64 expand."""
    mod = sys.modules[__name__]
    orig = mod._expand

    def expand(x, w1, a1, c1):
        _, eq, _ = orig(x, w1, a1, c1)
        e = (x[cand[:3]].double() @ w1.double()[:, cand[3]]).item()
        q = eq[cand].item()
        bits = torch.tensor([q]).bfloat16().view(torch.int16).item()
        step = 1 if (e > q) == (q >= 0) else -1
        eq = eq.clone()
        eq[cand] = torch.tensor([bits + step], dtype=torch.int16).view(
            torch.bfloat16).item()
        v1 = _q(x.dtype)(_q(x.dtype)(eq * a1) + c1)
        return _relu6(v1), eq, v1
    mod._expand = expand
    try:
        with torch.no_grad():
            return getattr(mod, name + "_reference")(*args, **kw)
    finally:
        mod._expand = orig


def unexplained(name, args, kw, got, want, log=print):
    """C3's rule for the halo phases F2 and B34 (``name`` "f2" or "b34"):
    the elements of their outputs over tolerance (as in
    :func:`max_err_vs_plain`) that no single eq value at a bf16 rounding
    boundary explains; returns ``(unexplained, explained count)``.

    No plain f32 order reproduces the tensor cores' sums (PERF.md, C3), so
    the kernel's eq = q(x @ w1) and the plain version's may round the same
    expand to neighbouring bf16 values where it lies near a boundary.  How
    near is not known from a model: the eqs the card showed lie 3.75 and
    2.24 f32 ulps from one (Cin 160, ten k-steps), so the window is one f32
    ulp a 16-deep k-step, ceil(Cin / 16) ulps, an assumption rather than a
    bound.  An element is explained when rounding one eq within the window
    and in its reach (the sums and weight gradients of its channel, dq's
    taps, dx's pixel) the other way in the plain version brings it within
    tolerance; each such trace goes to ``log``.  No element may pass
    ``FLIP_REL`` of its output's largest magnitude."""
    x, w1 = args[0], (args[1] if name == "f2" else args[3])
    B, H, W, Cin = x.shape
    Ce, r = w1.shape[1], kw["rate"]
    e64 = (x.double().reshape(-1, Cin) @ w1.double()).reshape(B, H, W, Ce)
    dist = boundary_ulps(e64)
    near = -(-Cin // 16)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    bad, explained = [], 0
    for o, (g, w) in enumerate(zip(got, want)):
        diff = (g.float() - w.float()).abs()
        scale = max(w.float().abs().max().item(), 1e-30)
        tol = PLAIN_BF16_REL if w.dtype == torch.bfloat16 else PLAIN_F32_REL
        if diff.max().item() > FLIP_REL * scale:
            bad.append((name, o, "over FLIP_REL"))
        for idx in torch.nonzero(diff > tol * scale).tolist():
            if w.dim() == 4 and w.shape[-1] == Cin and name == "b34":
                cands = [tuple(idx[:3]) + (c,) for c in range(Ce)]  # dx
            elif w.dim() == 4:                                   # dq's taps
                b, y, xx, c = idx
                cands = [(b, y + dy * r, xx + dx * r, c)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if 0 <= y + dy * r < H and 0 <= xx + dx * r < W]
            else:                                  # sums, dWdw, dW1^T
                c = idx[0] if w.shape == (Ce, Cin) else idx[-1]
                d, flat = torch.topk(dist[..., c].reshape(-1), 4,
                                     largest=False)
                cands = [tuple(torch.unravel_index(torch.tensor(i),
                                                   (B, H, W))) + (c,)
                         for i in flat.tolist()]
                cands = [tuple(int(v) for v in cd) for cd in cands]
            cands = sorted((dist[cd].item(), cd) for cd in cands)
            k, p = g.float()[tuple(idx)].item(), w.float()[tuple(idx)].item()
            for d, cd in [c for c in cands[:4] if c[0] <= near]:
                f = _flipped(name, args, kw, cd)[o].float()[tuple(idx)].item()
                if abs(f - k) <= tol * scale:
                    log(f"C3: {name} output {o} at {idx}: kernel {k:.6g}, "
                        f"plain {p:.6g} (rel {abs(k - p) / scale:.2e}, tol "
                        f"{tol}); eq at {list(cd)} lies {d:.2f} f32 ulps "
                        f"from a bf16 boundary, and rounded the other way "
                        f"brings the plain version to {f:.6g}")
                    explained += 1
                    break
            else:
                bad.append((name, o, idx))
    return bad, explained


# ---------------------------------------------------------------------------
# the block: glue between the phases, and its autograd Function
# ---------------------------------------------------------------------------

def _phase(name, plain):
    return getattr(sys.modules[__name__],
                   name + "_reference" if plain else name)


def _finalize(s, ss, n):
    mu = s / n
    return mu, torch.clamp(ss / n - mu * mu, min=0.0)


def _affine(gamma, beta, mu, var, dt):
    """ops/bn.py's scale and shift, rounded to the compute dtype, held f32."""
    rstd = torch.rsqrt(var + EPS)
    scale = gamma * rstd
    q = _q(dt)
    return q(scale), q(beta - mu * scale), rstd, scale


def _fwd_impl(plain, rate, skip, x, w1, g1, b1, wdw, g2, b2_, w2, g3, b3):
    B, H, W, _ = x.shape
    dt = x.dtype
    n = float(B * H * W)
    # w2 keeps its layout (the project kernel's transpose: F3 reads it as
    # w2^T without a copy)
    w1d, w2d = w1.to(dt).contiguous(), w2.to(dt)
    wdwf = wdw.float().contiguous()

    s1, ss1 = _phase("f1", plain)(x, w1d)
    mu1, var1 = _finalize(s1, ss1, n)
    a1, c1, _, _ = _affine(g1, b1, mu1, var1, dt)
    s2, ss2, dq = _phase("f2", plain)(x, w1d, a1, c1, wdwf, rate=rate)
    mu2, var2 = _finalize(s2, ss2, n)
    a2, c2, _, _ = _affine(g2, b2_, mu2, var2, dt)
    y = _phase("f3", plain)(dq, a2, c2, w2d)

    yf = y.float().reshape(-1, y.shape[-1])
    mu3, var3 = _finalize(yf.sum(0), (yf * yf).sum(0), n)
    a3, c3, _, _ = _affine(g3, b3, mu3, var3, dt)
    out = y * a3.to(dt) + c3.to(dt)
    if skip:
        out = out + x
    return out, (mu1, var1, mu2, var2, mu3, var3), y, dq


def _bwd_impl(plain, rate, skip, x, y, dq, w1, wdw, w2, g1, b1, g2, b2_, g3,
              stats, g_out):
    mu1, var1, mu2, var2, mu3, var3 = stats
    B, H, W, Cin = x.shape
    dt = x.dtype
    n = float(B * H * W)
    w1d, w2d = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    wdwf = wdw.float().contiguous()
    gp = g_out.to(dt).contiguous()

    # project BN: grad sums and the closed form of dL/dy_raw
    gf = gp.float().reshape(-1, gp.shape[-1])
    rstd1, rstd2, rstd3 = (torch.rsqrt(v + EPS) for v in (var1, var2, var3))
    yhat = (y.float().reshape(-1, y.shape[-1]) - mu3) * rstd3
    S1, S2 = gf.sum(0), (gf * yhat).sum(0)
    scale3 = g3 * rstd3
    k0 = scale3 * (-S1 / n + S2 * mu3 * rstd3 / n)
    k1 = -scale3 * S2 * rstd3 / n

    a1, c1, _, scale1 = _affine(g1, b1, mu1, var1, dt)
    a2, c2, _, scale2 = _affine(g2, b2_, mu2, var2, dt)
    T1, T2, dw2, ddh = _phase("b2", plain)(dq, gp, y, a2, c2, mu2, rstd2,
                                           w2d, scale3, k0, k1)
    m0 = scale2 * (-T1 / n + T2 * mu2 * rstd2 / n)
    m1 = -scale2 * T2 * rstd2 / n
    U1, U2, dwdw, dxp, dw1t = _phase("b34", plain)(
        x, dq, ddh, w1d, a1, c1, wdwf, a2, m0, m1, mu1, rstd1, rate=rate)
    l0 = scale1 * (-U1 / n + U2 * mu1 * rstd1 / n)
    l1 = -scale1 * U2 * rstd1 / n

    # BN1 mean-term corrections, analytic in x (the TPU kernel's _bwd_impl):
    #   dx  += l0 @ w1^T + x @ ((w1*l1) @ w1^T)
    #   dW1 += colsum(x) (x) l0 + (x^T x) @ (w1*l1)
    w1f = w1d.float()
    x2 = x.float().reshape(-1, Cin)
    M = (w1f * l1) @ w1f.t()
    dx = dxp.float().reshape(-1, Cin) + (l0[None] @ w1f.t()) + x2 @ M
    if skip:
        dx = dx + gf
    dx = dx.to(dt).reshape(B, H, W, Cin)
    dw1 = (dw1t.t() + torch.outer(x2.sum(0), l0)
           + (x2.t() @ x2) @ (w1f * l1))
    return dx, dw1, U2, U1, dwdw, T2, T1, dw2, S2, S1


class _BlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, g1, b1, wdw, g2, b2_, w2, g3, b3, rate, skip,
                plain):
        out, stats, y, dq = _fwd_impl(plain, rate, skip, x, w1, g1, b1, wdw,
                                      g2, b2_, w2, g3, b3)
        ctx.save_for_backward(x, y, dq, w1, wdw, w2, g1, b1, g2, b2_, g3,
                              *stats)
        ctx.rate, ctx.skip, ctx.plain = rate, skip, plain
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g_out, *_stat_grads):
        x, y, dq, w1, wdw, w2, g1, b1, g2, b2_, g3, *stats = \
            ctx.saved_tensors
        grads = _bwd_impl(ctx.plain, ctx.rate, ctx.skip, x, y, dq, w1, wdw,
                          w2, g1, b1, g2, b2_, g3, stats, g_out)
        return (*grads, None, None, None)


def block_train(x, w1, g1, b1, wdw, g2, b2, w2, g3, b3, *, rate: int,
                skip: bool, plain: bool = False):
    """Training-mode fused inverted-residual block (JAX ``block_train``).

    x (B, H, W, Cin) in the compute dtype; w1 (Cin, Ce), wdw (9, Ce) taps
    ((dy, dx) row-major), w2 (Ce, Cout) and the three BNs' gamma/beta, all
    f32.  Stride 1, SAME, dilation ``rate``; ``skip`` adds the residual.
    Returns ``(out, stats)`` with stats = (mu1, var1, mu2, var2, mu3, var3),
    the batch statistics for the caller's moving-average update (not
    differentiable).  ``plain`` runs every phase's plain version."""
    out, *stats = _BlockTrain.apply(x, w1, g1, b1, wdw, g2, b2, w2, g3, b3,
                                    rate, skip, plain)
    return out, tuple(stats)


def block_train_reference(*args, rate: int, skip: bool):
    """:func:`block_train` with every phase's plain version."""
    return block_train(*args, rate=rate, skip=skip, plain=True)


def fused_train_block_apply(net, x, prefix: str, rate: int, skip: bool,
                            policy):
    """One inverted-residual block (expand present, stride 1, training)
    through :func:`block_train`, reading the block's layers of ``net`` and
    applying each BN's moving-average update from the batch statistics (the
    JAX ``fused_train_block_apply``).  ``x`` is NCHW; the result is NCHW in
    channels-last memory."""
    L = lambda name: getattr(net, prefix + name)
    Ce = L("expand").kernel.shape[0]
    w1 = L("expand").kernel[:, :, 0, 0].t()
    wdw = L("depthwise").depthwise_kernel.reshape(Ce, 9).t()
    w2 = L("project").kernel[:, :, 0, 0].t()
    bns = [L(n) for n in ("expand_BN", "depthwise_BN", "project_BN")]
    xh = x.permute(0, 2, 3, 1).to(policy.dtype).contiguous()
    out, stats = block_train(xh, w1, bns[0].gamma, bns[0].beta, wdw,
                             bns[1].gamma, bns[1].beta, w2, bns[2].gamma,
                             bns[2].beta, rate=rate, skip=skip)
    with torch.no_grad():
        for bn, mu, var in zip(bns, stats[0::2], stats[1::2]):
            bn.update_moving(mu, var)
    return out.permute(0, 3, 1, 2)


def use_fused_train_block(net, x, policy, stride: int, block_id: int,
                          prefix: str) -> bool:
    """The JAX gate (``use_fused_train_block``): training, bf16 policy,
    stride 1, an expand conv (block_id != 0), height divisible by 8, and
    none of the block's six layers frozen, and no BN calibration running
    (``net.calibrating``: ``calibrate_bn`` takes the plain composition's
    statistics, as JAX's gate excludes ``bn_calibrate``), and no BN
    statistics shared across processes (the Trainer's SPMD mode over more
    than one process runs the composition, as JAX's multi-device SPMD step
    does).  On a CUDA tensor
    the block then runs the kernels; on a CPU tensor their plain
    versions."""
    if not (net.fuse_blocks and block_id and stride == 1 and net.training
            and not net.calibrating
            and policy.dtype == torch.bfloat16 and x.shape[2] % 8 == 0):
        return False
    names = ("expand", "expand_BN", "depthwise", "depthwise_BN", "project",
             "project_BN")
    if getattr(net, prefix + "expand_BN").group is not None:
        return False
    return not any(getattr(net, prefix + n).frozen for n in names)
