"""The port's training MBConv block (kernels/fused_mbconv_train.py) against
the JAX package's, on the CPU.

- Each plain phase against the Pallas phase it mirrors (``_run_f1`` ...
  ``_run_b34``, interpret mode, one channel chunk), on the inputs the port's
  block hands it, at the cases of tests/test_fused_mbconv_train.py.  f32:
  within 1e-4 of each output's largest magnitude (summation order only).
  bf16: bf16 outputs within 2 bf16 ulps of the largest value, f32 sums within
  1e-3 of it (a bf16 rounding of an intermediate may flip).
- ``block_train_reference`` (out, stats and all 10 gradients) against JAX
  ``block_train`` in interpret mode, f32, at 2e-4.
- The block wrapper on a module (output and EMA'd moving statistics) against
  JAX ``fused_train_block_apply``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu import core as jcore
from deeplab_tpu.kernels import fused_mbconv_train as JFMT

from deeplab_tpu_torch import core
from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
from deeplab_tpu_torch.params import params_from_jax

CASES = [
    (1, True, 8, 48, 8, 16, 16),
    (2, True, 8, 48, 8, 16, 24),
    (4, False, 16, 96, 24, 8, 16),
    (1, True, 8, 48, 8, 32, 16),
]
NAMES = ["x", "w1", "g1", "b1", "wdw", "g2", "b2", "w2", "g3", "b3"]


def _inputs(rate, Cin, Ce, Cout, H, W, B=2, seed=0):
    r = np.random.RandomState(seed)
    mk = lambda *s: r.randn(*s).astype(np.float32)
    return [mk(B, H, W, Cin), mk(Cin, Ce) * 0.3, 1 + 0.1 * mk(Ce),
            0.1 * mk(Ce), mk(9, Ce) * 0.3, 1 + 0.1 * mk(Ce), 0.1 * mk(Ce),
            mk(Ce, Cout) * 0.2, 1 + 0.1 * mk(Cout), 0.1 * mk(Cout)]


def _recorded_calls(args, rate, skip, dtype):
    """Run the port block forward and backward on the CPU; returns the
    recorded phase calls {phase: [(args, kw, out)]}."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    ts = [torch.from_numpy(a) for a in args]
    ts[0] = ts[0].to(tdt)
    ts = [t.requires_grad_() for t in ts]
    cot = torch.from_numpy(np.random.RandomState(7).randn(
        *args[0].shape[:3], args[7].shape[1]).astype(np.float32))
    with FMT.plain_versions() as calls:
        out, _ = FMT.block_train(*ts, rate=rate, skip=skip)
        (out.float() * cot).sum().backward()
    return calls


def _j(t, dt=None):
    a = jnp.asarray(t.detach().float().numpy())
    return a.astype(dt) if dt is not None else a


def _row(t):
    return _j(t).reshape(1, -1)


def _check(name, got_jax, want, tol_f32, tol_bf16):
    """JAX phase outputs against the port's plain phase outputs."""
    for i, (g, w) in enumerate(zip(got_jax, want)):
        w = w.detach().float().numpy()
        g = np.asarray(jnp.asarray(g).astype(jnp.float32)).reshape(w.shape)
        scale = max(np.abs(w).max(), 1e-30)
        tol = tol_bf16 if want[i].dtype == torch.bfloat16 else tol_f32
        err = np.abs(g - w).max()
        assert err <= tol * scale, (name, i, err, scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rate,skip,Cin,Ce,Cout,H,W", CASES)
def test_plain_phases_match_pallas_interpret(dtype, rate, skip, Cin, Ce,
                                             Cout, H, W):
    args = _inputs(rate, Cin, Ce, Cout, H, W)
    calls = _recorded_calls(args, rate, skip, dtype)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tol_f32, tol_bf16 = (1e-4, 1e-4) if dtype == "f32" else (1e-3, 2 ** -7)
    rows_t = 8
    B = args[0].shape[0]
    nt, P = H // rows_t, rows_t * W
    ZT = B * nt
    kw = dict(dt=jdt, nch=1, interpret=True)
    zp = lambda t, c: _j(t, jdt).reshape(ZT, P, c)

    (x, w1), _, (s1, ss1) = calls["f1"][0]
    got = JFMT._run_f1(zp(x, Cin), _j(w1, jdt), **kw)
    _check("f1", got, (s1, ss1), tol_f32, tol_bf16)

    (x, w1, a1, c1, wdw), fkw, want = calls["f2"][0]
    wdw16 = jnp.pad(_j(wdw), ((0, 7), (0, 0)))
    s, ss, dqs = JFMT._run_f2(zp(x, Cin), _j(w1, jdt), _row(a1), _row(c1),
                              wdw16, rate=rate, nt=nt, W=W, **kw)
    _check("f2", (s, ss, dqs), want, tol_f32, tol_bf16)

    (dq, a2, c2, w2), _, want = calls["f3"][0]
    got = JFMT._run_f3(zp(dq, Ce), _row(a2), _row(c2), _j(w2, jdt), **kw)
    _check("f3", (got,), (want,), tol_f32, tol_bf16)

    (dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1), _, want = \
        calls["b2"][0]
    w2t = _j(w2.t(), jdt)
    got = JFMT._run_b2(zp(dq, Ce), zp(g, Cout), zp(y, Cout), _row(a2),
                       _row(c2), _row(mu2), _row(rstd2), w2t, _row(gA3),
                       _row(k0), _row(k1), **kw)
    _check("b2", got, want[:3], tol_f32, tol_bf16)

    (x, dq_, ddh, w1, a1, c1, wdw, a2_, m0, m1, mu1, rstd1), bkw, want = \
        calls["b34"][0]
    u1, u2, dwdw, dxp, dw1t = JFMT._run_b34(
        zp(x, Cin), zp(dq, Ce), zp(g, Cout), zp(y, Cout), _j(w1, jdt),
        _row(a1), _row(c1), wdw16, _row(a2), _row(c2), _row(mu2),
        _row(rstd2), w2t, _j(w1.t(), jdt), _row(gA3), _row(k0), _row(k1),
        _row(m0), _row(m1), _row(mu1), _row(rstd1), rate=rate, nt=nt, W=W,
        **kw)
    _check("b34", (u1, u2, dwdw[:9], dxp, dw1t), want, tol_f32, tol_bf16)


@pytest.mark.parametrize("rate,skip,Cin,Ce,Cout,H,W", CASES)
def test_block_train_reference_matches_jax_block_train(rate, skip, Cin, Ce,
                                                       Cout, H, W):
    args = _inputs(rate, Cin, Ce, Cout, H, W)
    cot = np.random.RandomState(7).randn(2, H, W, Cout).astype(np.float32)

    def jfn(*a):
        wdw = jnp.pad(a[4], ((0, 7), (0, 0)))
        return JFMT.block_train(*a[:4], wdw, *a[5:], rate=rate, skip=skip,
                                interpret=True)
    (jout, jstats), vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jgrads = vjp((jnp.asarray(cot), tuple(jnp.zeros_like(s)
                                          for s in jstats)))

    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out, stats = FMT.block_train_reference(*ts, rate=rate, skip=skip)
    (out * torch.from_numpy(cot)).sum().backward()

    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    for got, want in zip(stats, jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)
    for name, t, want in zip(NAMES, ts, jgrads):
        want = np.asarray(want)
        if name == "wdw":
            want = want[:9]
        np.testing.assert_allclose(t.grad.numpy(), want, **tol,
                                   err_msg=f"grad {name}")


def _block_module(prefix, Cin, Ce, Cout, rate):
    from deeplab_tpu_torch.ops.bn import BatchNorm
    from deeplab_tpu_torch.ops.conv import Conv2D, DepthwiseConv2D
    net = torch.nn.Module()
    net.fuse_blocks = True
    net.add_module(prefix + "expand", Conv2D(Cin, Ce, 1))
    net.add_module(prefix + "expand_BN", BatchNorm(Ce, momentum=0.999))
    net.add_module(prefix + "depthwise", DepthwiseConv2D(Ce, 3, 1, rate))
    net.add_module(prefix + "depthwise_BN", BatchNorm(Ce, momentum=0.999))
    net.add_module(prefix + "project", Conv2D(Ce, Cout, 1))
    net.add_module(prefix + "project_BN", BatchNorm(Cout, momentum=0.999))
    return net


def test_block_wrapper_matches_jax_ctx_wrapper():
    """Output and EMA'd moving statistics of the port's
    ``fused_train_block_apply`` against JAX's, on shared weights and
    non-trivial moving statistics (dilated skip block, f32)."""
    from deeplab_tpu.models.mobilenetv2 import inverted_res_block
    p = "expanded_conv_3_"
    fwd = lambda ctx, v: inverted_res_block(
        ctx, v, expansion=6, stride=1, alpha=1.0, filters=8, block_id=3,
        skip_connection=True, rate=2)
    r = np.random.RandomState(1)
    x = r.randn(2, 16, 16, 8).astype(np.float32)
    params, state = jcore.init_model(fwd, jax.random.key(0), jnp.asarray(x))
    state = {ln: {vn: jnp.asarray(r.rand(*v.shape).astype(np.float32) * 0.5
                                  + 0.75) for vn, v in vs.items()}
             for ln, vs in state.items()}
    ctx = jcore.Ctx(mode="apply", params=params, state=state, training=True)
    ref = JFMT.fused_train_block_apply(ctx, jnp.asarray(x), p, rate=2,
                                       skip=True, interpret=True)

    net = _block_module(p, 8, 48, 8, 2).train()
    params_from_jax(net, jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, state))
    got = FMT.fused_train_block_apply(
        net, torch.from_numpy(x).permute(0, 3, 1, 2), p, 2, True,
        core.Policy(torch.float32))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ref), rtol=2e-4, atol=2e-4)
    for layer, vars_ in ctx.new_state.items():
        for var, want in vars_.items():
            np.testing.assert_allclose(
                getattr(getattr(net, layer), var).numpy(), np.asarray(want),
                rtol=2e-5, atol=1e-6, err_msg=f"{layer}/{var}")


def test_bf16_block_uses_phases_and_tracks_f32():
    """Under bf16 the block's output stays within bf16 error of the f32
    block, and each phase runs once forward or backward."""
    args = _inputs(2, 8, 48, 8, 16, 16)
    calls = _recorded_calls(args, 2, True, "bf16")
    assert all(len(calls[n]) == 1 for n in FMT.PHASES)
    ts = [torch.from_numpy(a) for a in args]
    ref, _ = FMT.block_train_reference(*ts, rate=2, skip=True)
    ts[0] = ts[0].bfloat16()
    got, _ = FMT.block_train_reference(*ts, rate=2, skip=True)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref.detach()).abs().max().item()
    assert err <= 0.1 * ref.abs().max().item(), err


def test_wrapper_refuses_unsupported_inputs_before_launch():
    """Off the CPU a phase checks its operands and raises rather than fall
    back; the meta device stands in for the card here."""
    x = torch.empty(2, 8, 8, 16, device="meta")
    w1 = torch.empty(16, 96, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FMT.f1(x, w1)
    assert FMT.f1.launches == 0
