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
import sys

import torch
import torch.nn.functional as F

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
    return _mm(b, w2, dt).to(dt).reshape(B, H, W, -1)


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

def _dims(B, H, W, Cin, Ce, Cout, rate):
    return (ctypes.c_int * 7)(B, H, W, Cin, Ce, Cout, rate)


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
    _launch("f1", [x, w1, out], _dims(B, H, W, Cin, Ce, 8, 1))
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
    _launch("f2", [x, w1, a1, c1, wdw, out, dq],
            _dims(B, H, W, Cin, Ce, 8, rate))
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
    _launch("f3", [dq, a2, c2, w2, y], _dims(B, H, W, 8, Ce, Cout, 1))
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
    _launch("b2", [dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1, t, dw2,
                   ddh], _dims(B, H, W, 8, Ce, Cout, 1))
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
    _launch("b34", [x, dq, ddh, w1, a1, c1, wdw, a2, m0, m1, mu1, rstd1, u,
                    dxp, dw1t], _dims(B, H, W, Cin, Ce, 8, rate))
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
    w1d, w2d = w1.to(dt).contiguous(), w2.to(dt).contiguous()
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
    none of the block's six layers frozen.  (The port has no BN-calibration
    mode.)  On a CUDA tensor the block then runs the kernels; on a CPU
    tensor their plain versions."""
    if not (net.fuse_blocks and block_id and stride == 1 and net.training
            and policy.dtype == torch.bfloat16 and x.shape[2] % 8 == 0):
        return False
    names = ("expand", "expand_BN", "depthwise", "depthwise_BN", "project",
             "project_BN")
    return not any(getattr(net, prefix + n).frozen for n in names)
