"""Fused eval-mode depthwise 3x3 + BN affine + relu6, one CUDA kernel.

Replaces the TPU kernel ``deeplab_tpu/kernels/fused_dw.py::fused_dw_bn_relu6``
(its ``pl.pallas_call`` at line 66); source ``csrc/fused_dw.cu``, whose header
says what bounds it on the H100 and how the design deals with that.  The
JAX package leaves the kernel unwired; the port runs MobileNetV2 block 0
(expansion 1, no expand conv, so ``fused_mbconv`` does not take it) through
it in eval mode under the bf16 and "mixed" policies
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

import torch
import torch.nn.functional as F

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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
    takes f32 or bf16 x, f32 taps and affine, all contiguous on x's card."""
    if x.device.type == "cpu":
        return fused_dw_bn_relu6_reference(x, dw_kernel, scale, shift,
                                           rate=rate, relu6=relu6)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dw_bn_relu6 runs on cuda or cpu, not "
                         f"{x.device}")
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
    vec4 = C % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _lib()
    rc = lib.fused_dw_launch(
        x.data_ptr(), dw_kernel.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), B, H, W, C, rate, int(relu6),
        int(x.dtype == torch.bfloat16), int(vec4),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_dw_bn_relu6 launch failed: "
                           + lib.fused_dw_error(rc).decode())
    fused_dw_bn_relu6.launches += 1
    return out


fused_dw_bn_relu6.launches = 0
