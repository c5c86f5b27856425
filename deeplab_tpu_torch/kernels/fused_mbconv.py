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

import torch
import torch.nn.functional as F

from deeplab_tpu_torch.ops.bn import bn_scale_shift

_SIGS = {"fused_mbconv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
         + [ctypes.c_void_p],
         "fused_sepconv": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
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
    the kernel (or raises); a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return fused_mbconv_reference(x, w1, b1, wdw, bdw, w2, b2, rate=rate,
                                      skip=skip, mxu_bf16=mxu_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on cuda or cpu, not {x.device}")
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
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_mbconv_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wdw.data_ptr(),
        bdw.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        B, H, W, Cin, Ce, Cout, rate, int(skip),
        int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("fused_mbconv launch failed: "
                           + lib.fused_mbconv_error(rc).decode())
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0


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
    runs the kernel (or raises); a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return fused_sepconv_reference(
            x, wdw, bdw, wpw, bpw, rate=rate, pre_relu=pre_relu,
            act_mid=act_mid, act_out=act_out, mxu_bf16=mxu_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_sepconv runs on cuda or cpu, not {x.device}")
    B, H, W, Cin = x.shape
    Cout = wpw.shape[1]
    if x.dtype == torch.float32 and not mxu_bf16:
        raise ValueError("fused_sepconv takes f32 input only under mxu_bf16; "
                         "the float32 policy keeps the plain composition")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported input dtype {x.dtype}")
    if Cout % 8 or rate < 1:
        raise ValueError(f"unsupported shape Cout={Cout}, rate={rate}")
    _check_weights(x, {"wdw": (wdw, (9, Cin), torch.float32),
                       "bdw": (bdw, (Cin,), torch.float32),
                       "wpw": (wpw, (Cin, Cout), torch.bfloat16),
                       "bpw": (bpw, (Cout,), torch.float32)})
    if wpw.data_ptr() % 16:
        raise ValueError("wpw must be 16-byte aligned (the kernel reads it "
                         "by 16-byte vectors)")
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    lib = _lib("fused_sepconv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_sepconv_launch(
        x.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), wpw.data_ptr(),
        bpw.data_ptr(), out.data_ptr(), B, H, W, Cin, Cout, rate,
        int(pre_relu), int(act_mid), int(act_out),
        int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("fused_sepconv launch failed: "
                           + lib.fused_sepconv_error(rc).decode())
    fused_sepconv.launches += 1
    return out


fused_sepconv.launches = 0


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
