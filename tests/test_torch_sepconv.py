"""The port's SepConv_BN and its fused kernel against the JAX package's, on
the CPU.

``fused_sepconv_reference`` (the plain PyTorch twin of the CUDA kernel)
against the Pallas kernel in interpret mode; the port's
``fused_sepconv_apply`` (BN folding, activation placement) against JAX's;
the plain version at a rate the TPU kernel cannot take (its halo comes only
from the neighbouring row tiles) against the JAX ``sep_conv_bn``
composition; the strided composition and the fixed-padding convs.  The CUDA
kernel itself runs only on the card (tests/test_torch_kernels_gpu.py,
``chip_smoke.py``).

Tolerances: in f32 both sides compute the same f32 products and differ only
in summation order: 2e-4 (as tests/test_fused_mbconv.py), 1e-4 of the
largest value for the composition.  In bf16 a summation-order ulp in the f32
depthwise can flip the bf16 rounding of one pointwise operand (2^-8
relative) and the bf16 output rounds once more: 2 bf16 ulps of the largest
value.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu import core as jcore
from deeplab_tpu.kernels import fused_mbconv as JFM
from deeplab_tpu.ops import conv as jconv
from deeplab_tpu.ops import resize as jresize

from deeplab_tpu_torch import core
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.ops import conv, resize
from deeplab_tpu_torch.params import _to_port_layout, params_from_jax

F32 = core.resolve_compute_dtype("float32")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _bf16_ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("rate,pre_relu,Cin", [
    (1, True, 16), (1, False, 16), (2, True, 16), (2, False, 16),
    (4, True, 16), (4, False, 16),
    (2, True, 40),                   # ragged Cin: a chunk of 32 plus 8
])
def test_reference_matches_pallas_interpret(mode, rate, pre_relu, Cin):
    r = np.random.RandomState(rate + Cin)
    B, H, W, Cout = 2, 16, 24, 24
    x = r.randn(B, H, W, Cin).astype(np.float32)
    wdw = (r.randn(9, Cin) * 0.3).astype(np.float32)
    bdw = (r.randn(Cin) * 0.1).astype(np.float32)
    wpw = (r.randn(Cin, Cout) * 0.2).astype(np.float32)
    bpw = (r.randn(Cout) * 0.1).astype(np.float32)
    act = not pre_relu
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    ref = JFM.fused_sepconv(
        jnp.asarray(x).astype(jdt), jnp.pad(jnp.asarray(wdw), ((0, 7), (0, 0))),
        jnp.asarray(bdw)[None], jnp.asarray(wpw).astype(jdt),
        jnp.asarray(bpw)[None], rate=rate, pre_relu=pre_relu, act_mid=act,
        act_out=act, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = torch.bfloat16 if mode == "bf16" else torch.float32
    got = FM.fused_sepconv(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wdw),
        torch.from_numpy(bdw), torch.from_numpy(wpw).to(tdt),
        torch.from_numpy(bpw), rate=rate, pre_relu=pre_relu, act_mid=act,
        act_out=act)
    assert got.dtype == tdt and got.shape == (B, H, W, Cout)
    if mode == "f32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    else:
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= 2 * _bf16_ulp(ref), (err, _bf16_ulp(ref))


def _jax_sepconv(depth_act, rate, stride, eps, x, seed):
    """JAX sep_conv_bn's params with random moving statistics, and its
    output in eval mode."""
    fwd = functools.partial(jconv.sep_conv_bn, filters=24, prefix="sc",
                            stride=stride, rate=rate,
                            depth_activation=depth_act, epsilon=eps)
    r = np.random.RandomState(seed)
    params, state = jcore.init_model(lambda ctx, v: fwd(ctx, v),
                                     jax.random.key(seed), jnp.asarray(x))
    state = {ln: {"moving_mean": jnp.asarray(
                      r.randn(*vs["moving_mean"].shape).astype(np.float32)
                      * 0.1),
                  "moving_variance": jnp.asarray(
                      r.rand(*vs["moving_variance"].shape).astype(np.float32)
                      + 0.5)}
             for ln, vs in state.items()}
    ref, _ = jcore.apply_model(lambda ctx, v: fwd(ctx, v), params, state,
                               jnp.asarray(x))
    return params, state, np.asarray(ref)


def _port_sepconv(params, state, cin, rate, stride, eps, fuse=True):
    net = torch.nn.Module()
    conv.build_sep_conv_bn(net.add_module, None, "sc", cin, 24, stride, rate,
                           eps)
    params_from_jax(net, jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, state))
    net.fuse_blocks = fuse
    return net.eval()


@pytest.mark.parametrize("rate,depth_act,eps", [(1, False, 1e-3),
                                                (2, True, 1e-5),
                                                (4, False, 1e-3)])
def test_fused_sepconv_apply_matches_jax(rate, depth_act, eps):
    """BN folding (each BN's own eps) and activation placement, on the same
    params and non-trivial moving statistics, f32."""
    x = np.random.RandomState(5).rand(2, 16, 24, 16).astype(np.float32) * 2 - 1
    params, state, _ = _jax_sepconv(depth_act, rate, 1, eps, x, rate)
    ctx = jcore.Ctx(mode="apply", params=params, state=state)
    ref = JFM.fused_sepconv_apply(ctx, jnp.asarray(x), "sc", rate=rate,
                                  depth_activation=depth_act, epsilon=eps,
                                  interpret=True)
    net = _port_sepconv(params, state, 16, rate, 1, eps)
    with torch.no_grad():
        got = FM.fused_sepconv_apply(net, _nchw(x), "sc", rate, depth_act,
                                     F32)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("depth_act", [False, True])
def test_plain_version_at_rate_past_the_map_matches_composition(depth_act):
    """Rate 12 on an 8x8 map (every off-centre tap reads SAME zeros, as the
    ASPP's rate 18 on 32x32 does at 512x512): the plain version the gate
    runs under "mixed" and bf16, here in f32, against JAX's sep_conv_bn."""
    x = np.random.RandomState(6).randn(2, 8, 8, 16).astype(np.float32)
    params, state, ref = _jax_sepconv(depth_act, 12, 1, 1e-5, x, 7)
    net = _port_sepconv(params, state, 16, 12, 1, 1e-5)
    with torch.no_grad():
        got = _nhwc(FM.fused_sepconv_apply(net, _nchw(x), "sc", 12,
                                           depth_act, F32))
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("stride,rate", [(1, 2), (2, 1)])
def test_composition_matches_jax(stride, rate):
    """The port's sep_conv_bn composition (the float32 and training path,
    and every strided SepConv: fixed pads and VALID) against JAX's."""
    x = np.random.RandomState(8).randn(2, 15, 16, 16).astype(np.float32)
    params, state, ref = _jax_sepconv(False, rate, stride, 1e-3, x, 9)
    net = _port_sepconv(params, state, 16, rate, stride, 1e-3, fuse=False)
    with torch.no_grad():
        got = _nhwc(conv.sep_conv_bn(net, _nchw(x), F32, "sc"))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_gate_engages_on_eval_stride1_mixed_and_bf16_only():
    net = torch.nn.Module()
    net.fuse_blocks = True
    pol = core.resolve_compute_dtype
    assert conv.use_fused_sepconv(net.eval(), pol("mixed"), 1)
    assert conv.use_fused_sepconv(net, pol("bfloat16"), 1)
    assert not conv.use_fused_sepconv(net, pol("mixed"), 2)
    assert not conv.use_fused_sepconv(net, pol("float32"), 1)
    assert not conv.use_fused_sepconv(net.train(), pol("mixed"), 1)
    net.eval().fuse_blocks = False
    assert not conv.use_fused_sepconv(net, pol("mixed"), 1)


@pytest.mark.parametrize("hw,k,stride", [(16, 3, 1), (16, 3, 2), (15, 3, 2),
                                         (16, 1, 2)])
def test_conv2d_fixed_matches(hw, k, stride):
    r = np.random.RandomState(10)
    x = r.randn(2, hw, hw, 8).astype(np.float32)
    w = (r.randn(k, k, 8, 12) * 0.3).astype(np.float32)
    ctx = jcore.Ctx(mode="apply", params={"c": {"kernel": jnp.asarray(w)}},
                    state={})
    ref = jconv.conv2d_fixed(ctx, jnp.asarray(x), 12, "c", stride=stride,
                             kernel_size=k)
    got = conv.conv2d_fixed(_nchw(x), _to_port_layout("kernel", w), F32,
                            stride=stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("src,dst", [((8, 8), (32, 32)), ((5, 7), (16, 13)),
                                     ((9, 9), (4, 4))])
def test_resize_nearest_tf1_matches(src, dst):
    x = np.random.RandomState(11).randn(2, src[0], src[1], 3).astype(
        np.float32)
    ref = jresize.resize_nearest_tf1(jnp.asarray(x), dst)
    got = resize.resize_nearest_tf1(_nchw(x), dst)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


def test_wrapper_refuses_unsupported_inputs_before_launch():
    """On a non-CPU device the wrapper checks its inputs and raises rather
    than fall back; the meta device stands in for the card here."""
    x = torch.empty(1, 8, 8, 16, device="meta")
    w = dict(wdw=torch.empty(9, 16, device="meta"),
             bdw=torch.empty(16, device="meta"),
             wpw=torch.empty(16, 24, device="meta"),
             bpw=torch.empty(24, device="meta"))
    with pytest.raises(ValueError):
        FM.fused_sepconv(x, **w, rate=1, pre_relu=True, act_mid=False,
                         act_out=False, mxu_bf16=True)
    assert FM.fused_sepconv.launches == 0
