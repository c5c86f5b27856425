"""The port's fused MBConv block against the JAX package's.

On the CPU: ``fused_mbconv_reference`` (the plain PyTorch twin of the CUDA
kernel) against the Pallas kernel in interpret mode, in the three precision
modes; and the port's ``fused_block_apply`` (BN folding) against JAX's on
shared weights with non-trivial BN statistics.  The CUDA kernel itself runs
only on the card: tests/test_torch_kernels_gpu.py and ``chip_smoke.py``
hold it against the plain version.

Tolerances: in f32 both sides compute the same f32 products and differ only
in summation order (2e-4, as tests/test_fused_mbconv.py).  Under mxu_bf16 and
bf16 the matmul products are exact on both sides, but a summation-order ulp
in the f32 depthwise sum can flip the bf16 rounding of one expanded value
(2^-8 relative), and bf16 outputs carry their own 2^-8 rounding: 2e-2 at
outputs of order 1, as the JAX package's mixed-policy test.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu import core as jcore
from deeplab_tpu.kernels import fused_mbconv as JFM
from deeplab_tpu.models.mobilenetv2 import inverted_res_block

from deeplab_tpu_torch import core
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.params import params_from_jax


def _weights(r, Cin, Ce, Cout):
    return dict(
        w1=(r.randn(Cin, Ce) * 0.2).astype(np.float32),
        b1=(r.randn(Ce) * 0.1).astype(np.float32),
        wdw=(r.randn(9, Ce) * 0.2).astype(np.float32),
        bdw=(r.randn(Ce) * 0.1).astype(np.float32),
        w2=(r.randn(Ce, Cout) * 0.1).astype(np.float32),
        b2=(r.randn(Cout) * 0.1).astype(np.float32))


@pytest.mark.parametrize("mode", ["f32", "mxu_bf16", "bf16"])
@pytest.mark.parametrize("rate,skip,Cin,Ce,Cout,H,W", [
    (1, True, 8, 48, 8, 16, 16),
    (2, True, 8, 48, 8, 16, 24),     # dilated, non-square
    (4, False, 16, 96, 24, 8, 16),   # rate 4, channel change
])
def test_reference_matches_pallas_interpret(mode, rate, skip, Cin, Ce, Cout,
                                            H, W):
    r = np.random.RandomState(0)
    x = r.randn(2, H, W, Cin).astype(np.float32)
    w = _weights(r, Cin, Ce, Cout)
    mxu = mode == "mxu_bf16"
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    wdt = jnp.float32 if mode == "f32" else jnp.bfloat16
    ref = JFM.fused_mbconv(
        jnp.asarray(x).astype(jdt), jnp.asarray(w["w1"]).astype(wdt),
        jnp.asarray(w["b1"])[None], jnp.pad(jnp.asarray(w["wdw"]),
                                            ((0, 7), (0, 0))),
        jnp.asarray(w["bdw"])[None], jnp.asarray(w["w2"]).astype(wdt),
        jnp.asarray(w["b2"])[None], rate=rate, skip=skip, mxu_bf16=mxu,
        interpret=True)
    tdt = torch.bfloat16 if mode == "bf16" else torch.float32
    twdt = torch.float32 if mode == "f32" else torch.bfloat16
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    got = FM.fused_mbconv(
        torch.from_numpy(x).to(tdt), t["w1"].to(twdt), t["b1"], t["wdw"],
        t["bdw"], t["w2"].to(twdt), t["b2"], rate=rate, skip=skip,
        mxu_bf16=mxu)
    assert got.dtype == tdt and got.shape == (2, H, W, Cout)
    tol = 2e-4 if mode == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("policy", ["float32", "mixed"])
def test_fused_block_apply_matches_jax(policy):
    """BN folding: the port's fused_block_apply against JAX's on the same
    params and non-trivial moving statistics (dilated skip block)."""
    fwd = functools.partial(inverted_res_block, expansion=6, stride=1,
                            alpha=1.0, filters=8, block_id=3,
                            skip_connection=True, rate=2)
    r = np.random.RandomState(1)
    x = (r.rand(2, 16, 16, 8).astype(np.float32) * 2 - 1)
    params, state = jcore.init_model(lambda ctx, v: fwd(ctx, v),
                                     jax.random.key(0), jnp.asarray(x))
    state = {ln: {vn: jnp.asarray(r.rand(*v.shape).astype(np.float32) * 0.5
                                  + 0.75) for vn, v in vs.items()}
             for ln, vs in state.items()}
    pol = core.resolve_compute_dtype(policy)
    ctx = jcore.Ctx(mode="apply", params=params, state=state,
                    mxu_bf16=pol.mxu_bf16)
    ref = JFM.fused_block_apply(ctx, jnp.asarray(x), "expanded_conv_3_",
                                rate=2, skip=True, interpret=True)

    net = torch.nn.Module()
    from deeplab_tpu_torch.ops.bn import BatchNorm
    from deeplab_tpu_torch.ops.conv import Conv2D, DepthwiseConv2D
    p = "expanded_conv_3_"
    net.add_module(p + "expand", Conv2D(8, 48, 1))
    net.add_module(p + "expand_BN", BatchNorm(48))
    net.add_module(p + "depthwise", DepthwiseConv2D(48, 3, 1, 2))
    net.add_module(p + "depthwise_BN", BatchNorm(48))
    net.add_module(p + "project", Conv2D(48, 8, 1))
    net.add_module(p + "project_BN", BatchNorm(8))
    params_from_jax(net, jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, state))
    with torch.no_grad():
        got = FM.fused_block_apply(net, torch.from_numpy(x).permute(0, 3, 1, 2),
                                   p, 2, True, pol)
    tol = 2e-4 if policy == "float32" else 2e-2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=tol, atol=tol)


def test_wrapper_refuses_unsupported_inputs_before_launch():
    """On a non-CPU device the wrapper checks its inputs and raises rather
    than fall back; the meta device stands in for the card here."""
    x = torch.empty(1, 8, 8, 8, device="meta")
    w = {k: torch.empty(s, device="meta") for k, s in
         dict(w1=(8, 48), b1=(48,), wdw=(9, 48), bdw=(48,), w2=(48, 8),
              b2=(8,)).items()}
    with pytest.raises(ValueError):
        FM.fused_mbconv(x, **w, rate=1, skip=True)
    assert FM.fused_mbconv.launches == 0
