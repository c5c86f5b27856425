"""The port's fused depthwise 3x3 + BN affine + relu6 on the CPU: its plain
version against the JAX Pallas kernel in interpret mode, and the MobileNetV2
block-0 gate that runs it.

Tolerances: f32 outputs within 1e-5 of the largest value (both sum the 9
products in f32, in another order); bf16 outputs within 2 bf16 ulps of the
largest value (a summation-order difference can flip one rounding).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deeplab_tpu.kernels.fused_dw import fused_dw_bn_relu6 as jax_fused_dw

from deeplab_tpu_torch import SegNet
from deeplab_tpu_torch import core
from deeplab_tpu_torch.kernels import fused_dw as FDW
from deeplab_tpu_torch.models import mobilenetv2 as M
from deeplab_tpu_torch.ops.conv import relu6

F32_REL, BF16_REL = 1e-5, 2 * 2.0 ** -8


def _inputs(C, seed=0, B=2, H=12, W=16):
    r = np.random.RandomState(seed)
    return (r.randn(B, H, W, C).astype(np.float32),
            (r.randn(3, 3, C, 1) * 0.3).astype(np.float32),
            (r.rand(C) + 0.5).astype(np.float32),
            (r.randn(C) * 0.5).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("rate", [1, 2, 4])
@pytest.mark.parametrize("C", [8, 32, 128])
def test_plain_version_matches_jax_kernel(C, rate, relu, dtype):
    x, k, scale, shift = _inputs(C, seed=C + rate)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_fused_dw(jx, jnp.asarray(k), jnp.asarray(scale),
                                   jnp.asarray(shift), rate=rate,
                                   relu6=relu, interpret=True), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = FDW.fused_dw_bn_relu6(tx, torch.from_numpy(k),
                                torch.from_numpy(scale),
                                torch.from_numpy(shift), rate=rate,
                                relu6=relu)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    err = np.abs(got.float().numpy() - want).max()
    scale_ = np.abs(want).max()
    tol = F32_REL if dtype == "float32" else BF16_REL
    assert scale_ > 0 and err <= tol * scale_, (err, scale_)
    assert FDW.fused_dw_bn_relu6.launches == 0     # the CPU launches nothing


@pytest.fixture
def calls(monkeypatch):
    """Count the gate's calls of the wrapper (on the CPU it launches no
    kernel, so its launch count stays 0)."""
    n = []
    wrapper = FDW.fused_dw_bn_relu6

    def counting(*args, **kw):
        n.append(args[0].shape)
        return wrapper(*args, **kw)
    monkeypatch.setattr(FDW, "fused_dw_bn_relu6", counting)
    return n


def _net(**kw):
    net = SegNet((32, 32), 3, alpha=0.35, **kw).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        bn = net.expanded_conv_depthwise_BN
        c = bn.gamma.shape[0]
        bn.moving_mean.copy_(torch.randn(c, generator=gen) * 0.1)
        bn.moving_variance.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.gamma.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.beta.copy_(torch.randn(c, generator=gen) * 0.1)
    return net


@pytest.mark.parametrize("policy", ["mixed", "bfloat16"])
def test_gate_runs_block_0_once_per_forward(calls, policy):
    net = _net()
    img = torch.rand(2, 32, 32, 3) * 255
    out = net.logits(img, policy)
    assert torch.isfinite(out.float()).all()
    # block 0 at half the input size, 16 channels at alpha 0.35
    assert calls == [(2, 16, 16, 16)]


@pytest.mark.parametrize("case", ["float32", "training", "unfused"])
def test_gate_keeps_the_composition(calls, case):
    net = _net(fuse_blocks=case != "unfused")
    img = torch.rand(2, 32, 32, 3) * 255
    if case == "training":
        net.train()
        net.apply_logits(img, "bfloat16", gen=torch.Generator().manual_seed(0))
    else:
        net.logits(img, "float32" if case == "float32" else "mixed")
    assert calls == []


def test_block_0_through_the_kernel_matches_the_f32_composition():
    """The folded BN and the NHWC round trip: block 0's depthwise -> BN ->
    relu6 through the plain kernel (f32 input, as under "mixed") against the
    f32 layer composition, within 1e-5 of the largest value."""
    net = _net()
    x = torch.randn(2, 16, 16, 16).to(memory_format=torch.channels_last)
    p = M._prefix(0)
    policy = core.resolve_compute_dtype("mixed")
    got = M.fused_dw_apply(net, x, p, 1, policy)
    f32 = core.resolve_compute_dtype("float32")
    with torch.no_grad():
        want = relu6(getattr(net, p + "depthwise_BN")(
            getattr(net, p + "depthwise")(x, f32)))
    err = (got - want).abs().max().item()
    assert err <= F32_REL * want.abs().max().item(), err
