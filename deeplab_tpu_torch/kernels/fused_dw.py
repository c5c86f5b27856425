"""Fused eval-mode depthwise 3x3 + BN affine + relu6, one CUDA kernel.

Replaces the TPU kernel ``deeplab_tpu/kernels/fused_dw.py::fused_dw_bn_relu6``
(its ``pl.pallas_call`` at line 66); source ``csrc/fused_dw.cu``, whose header
says what bounds it on the H100 and how the design deals with that: a block
streams down a strip of columns through a ring of input rows that cp.async
fills ahead of the arithmetic.  :func:`dw_plan` decides the launch (strip
width, rows a block, channel chunk, prefetch depth); the launcher checks
it.  The JAX package leaves the kernel unwired; the port runs MobileNetV2
block 0 (expansion 1, no expand conv, so ``fused_mbconv`` does not take it)
through it in eval mode under the bf16 and "mixed" policies
(``models/mobilenetv2.py``).

``fused_dw_bn_relu6_reference`` is the plain PyTorch version of the same
function: the 9 shifted products summed in f32 in the kernel's order (dy
outer, dx inner, as the TPU kernel sums them), the affine and the clamp.
The kernel is built with ``-fmad=false``, so the two agree bit for bit: a
seeded 60-layer net turns a last-bit difference at block 0 into bf16
rounding flips downstream.  A CPU tensor runs the plain version; a CUDA
tensor runs the kernel or raises.  As in the TPU kernel the taps accumulate
in f32 in every mode and the output takes x's dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from deeplab_tpu_torch.kernels import ops as OPS

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p]

# Launch geometry of csrc/fused_dw.cu, decided here and checked there.
DW_SMEM_LIMIT = 232448       # dynamic shared memory a block may use (H100)
DW_SM_SMEM = 233472          # shared memory of an SM; 1 KB more a block
DW_SM_COUNT = 132
DW_MAX_THREADS = 256         # a thread per (column, vector) of the strip
DW_STRIPS = (64, 32, 16, 8)  # output columns a block
DW_CHUNKS = (16, 8, 4, 2, 1) # most vectors of channels a block
DW_PREFETCH = (4, 3, 2, 1)   # input rows in flight beyond the 2 rate + 1
DW_ROW_STEP = 8              # rows a block: multiples of this, or H


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def dw_vec(C: int, esize: int, *ptrs) -> int:
    """Channels a vector: the most, up to 16 bytes, that divide C and keep
    every pointer in ``ptrs`` aligned to the vector."""
    vec = 16 // esize
    while vec > 1 and (C % vec or any(p % (vec * esize) for p in ptrs)):
        vec //= 2
    return vec


def dw_blocks_per_sm(threads: int, smem: int, vec: int, esize: int) -> int:
    """Blocks of a launch an SM holds: by threads, by shared memory, and by
    registers (the launch bounds of csrc/fused_dw.cu cap a thread at 128
    registers for 16-byte bf16 vectors, whose 72 taps sit in registers, at
    85 otherwise: two and three blocks of 256 threads)."""
    min_blocks = 2 if (vec, esize) == (8, 2) else 3
    return max(0, min(32, 2048 // threads, DW_SM_SMEM // (smem + 1024),
                      min_blocks * DW_MAX_THREADS // threads))


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One ``fused_dw_bn_relu6`` launch: a block per (strip of ``sw``
    output columns, segment of ``th`` rows, chunk of ``cv`` vectors of
    ``vec`` channels, image); ``threads = sw * cv``; a ring of
    ``2 rate + 1 + prefetch`` input rows of ``sw + 2 rate`` pixels in
    ``smem`` bytes; the grid ``(strips_x, strips_y, chunks * B)``."""
    sw: int
    th: int
    cv: int
    vec: int
    prefetch: int
    threads: int
    smem: int
    strips_x: int
    strips_y: int
    chunks: int
    B: int
    est: float       # the cost model's estimate (vectors moved over the
                     # waves' fill), for the choice

    @property
    def grid(self):
        return (self.strips_x, self.strips_y, self.chunks * self.B)


def dw_smem(rate: int, sw: int, cv: int, vec: int, esize: int,
            prefetch: int) -> int:
    """The ring: 2 rate + 1 + prefetch rows of (sw + 2 rate) pixels of cv
    vectors."""
    return (2 * rate + 1 + prefetch) * (sw + 2 * rate) * cv * vec * esize


@functools.lru_cache(maxsize=256)
def dw_plan(B, H, W, C, rate, dtype=torch.float32, vec=None) -> DwPlan:
    """Choose the channel chunk, strip width, rows a block and prefetch
    depth of a launch.  The chunk is the widest of DW_CHUNKS vectors (all of
    a pixel's channels up to 256 bytes: the longest contiguous runs of
    device memory) whose ring fits at some strip width, the vectors split
    evenly over the chunks.  The kernel is bound by device memory, so among
    the strip widths and row counts whose ring fits take the least
    estimated time: the vectors all blocks move (input rows with their
    halo, read once a block, and the outputs) over the share of the SMs'
    block slots that the waves fill (a wave's last blocks leave the memory
    system idle).  The deepest prefetch that fits.  ``vec`` defaults to the
    widest vector C allows (the wrapper passes the one its pointers allow
    too)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if vec is None:
        vec = dw_vec(C, esize)
    if C % vec or rate < 1:
        raise ValueError(f"fused_dw takes no vector of {vec} at C={C}, "
                         f"rate={rate}")
    nvec = C // vec
    rows = sorted({min(t, H) for t in range(DW_ROW_STEP, H + DW_ROW_STEP,
                                            DW_ROW_STEP)})
    for cmax in DW_CHUNKS:
        chunks = _ceil(nvec, min(cmax, nvec))
        cv = _ceil(nvec, chunks)
        best = None
        for sw in DW_STRIPS:
            threads = sw * cv
            if threads > DW_MAX_THREADS or (sw >= 2 * W
                                            and sw != DW_STRIPS[-1]):
                continue                   # too many threads; past the map
            fits = [p for p in DW_PREFETCH
                    if dw_smem(rate, sw, cv, vec, esize, p) <= DW_SMEM_LIMIT]
            if not fits:
                continue
            smem = dw_smem(rate, sw, cv, vec, esize, fits[0])
            slots = DW_SM_COUNT * dw_blocks_per_sm(threads, smem, vec, esize)
            for th in rows:
                blocks = _ceil(W, sw) * _ceil(H, th) * chunks * B
                moved = ((th + 2 * rate) * (sw + 2 * rate) + th * sw) * cv
                est = moved * _ceil(blocks, slots) * slots
                key = (est, blocks)
                if best is None or key < best[0]:
                    best = (key, DwPlan(sw, th, cv, vec, fits[0], threads,
                                        smem, _ceil(W, sw), _ceil(H, th),
                                        chunks, B, float(est)))
        if best is not None:
            return best[1]
    raise ValueError(f"no fused_dw ring fits rate={rate}, C={C}")


def _lib():
    from deeplab_tpu_torch.kernels import build
    lib = build.load("fused_dw")
    if lib.fused_dw_launch.argtypes is None:
        lib.fused_dw_launch.argtypes = _SIG
        lib.fused_dw_launch.restype = ctypes.c_int
        lib.fused_dw_error.argtypes = [ctypes.c_int]
        lib.fused_dw_error.restype = ctypes.c_char_p
    return lib


def fused_dw_bn_relu6_reference(x, dw_kernel, scale, shift, rate: int = 1,
                                relu6: bool = True):
    """x: (B, H, W, C) f32 or bf16; dw_kernel: (3, 3, C, 1) Keras layout;
    scale/shift: (C,) folded BN affine (gamma/sqrt(var+eps),
    beta-mean*scale).  Stride-1 SAME depthwise with dilation ``rate``, in
    f32; returns (B, H, W, C) in x's dtype."""
    _, H, W, C = x.shape
    r = rate
    xp = F.pad(x.float(), (0, 0, r, r, r, r))
    k = dw_kernel.float().reshape(3, 3, C)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(3):
        for j in range(3):
            acc = acc + xp[:, i * r:i * r + H, j * r:j * r + W] * k[i, j]
    y = acc * scale.float() + shift.float()
    if relu6:
        y = torch.clamp(y, 0.0, 6.0)
    return y.to(x.dtype)


def fused_dw_bn_relu6(x, dw_kernel, scale, shift, rate: int = 1,
                      relu6: bool = True):
    """Same arguments as :func:`fused_dw_bn_relu6_reference`.  The kernel
    takes f32 or bf16 x, f32 taps and affine, all contiguous on x's card.
    One call is one ``deeplab_tpu_torch::fused_dw_bn_relu6`` operator."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dw_bn_relu6 runs on cuda or cpu, not "
                         f"{x.device}")
    return _fused_dw_op(x, dw_kernel, scale, shift, rate, relu6)


def _fused_dw_cuda(x, dw_kernel, scale, shift, rate, relu6):
    """The operator's CUDA implementation: check, plan and launch."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x: want (B, H, W, C) f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, H, W, C = x.shape
    if rate < 1:
        raise ValueError(f"rate must be >= 1, got {rate}")
    for name, t, shape in (("x", x, (B, H, W, C)),
                           ("dw_kernel", dw_kernel, (3, 3, C, 1)),
                           ("scale", scale, (C,)), ("shift", shift, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t is not x and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    out = torch.empty_like(x)
    vec = dw_vec(C, x.element_size(), x.data_ptr(), out.data_ptr())
    plan = dw_plan(B, H, W, C, rate, x.dtype, vec)
    lib = _lib()
    rc = lib.fused_dw_launch(
        x.data_ptr(), dw_kernel.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), B, H, W, C, rate, int(relu6),
        int(x.dtype == torch.bfloat16), vec, plan.sw, plan.th, plan.cv,
        plan.prefetch, plan.threads, plan.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_dw_bn_relu6 launch failed: "
                           + lib.fused_dw_error(rc).decode())
    fused_dw_bn_relu6.launches += 1
    return out


fused_dw_bn_relu6.launches = 0
_fused_dw_op = OPS.define(
    "fused_dw_bn_relu6(Tensor x, Tensor dw_kernel, Tensor scale, "
    "Tensor shift, int rate, bool relu6) -> Tensor",
    cuda=_fused_dw_cuda,
    cpu=lambda x, dw_kernel, scale, shift, rate, relu6:
        fused_dw_bn_relu6_reference(x, dw_kernel, scale, shift, rate=rate,
                                    relu6=relu6).contiguous(),
    fake=lambda x, dw_kernel, scale, shift, rate, relu6: torch.empty_like(x))
