"""Port ops (deeplab_tpu_torch/ops) against the JAX ops, on the CPU, in f32.

Inputs come from numpy and go to both packages.  Tolerances: the two
frameworks sum conv products in different orders, so f32 results agree to a
few ulps of the output scale (atol 1e-5 at outputs of order 1); the padding
arithmetic and the resize matrices must agree exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deeplab_tpu import core as jcore
from deeplab_tpu.ops import bn as jbn
from deeplab_tpu.ops import conv as jconv
from deeplab_tpu.ops import padding as jpad
from deeplab_tpu.ops import resize as jresize

from deeplab_tpu_torch import core
from deeplab_tpu_torch.ops import bn, conv, padding, resize
from deeplab_tpu_torch.params import _to_port_layout

F32 = core.resolve_compute_dtype("float32")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _ctx(params, state=None, **kw):
    return jcore.Ctx(mode="apply", params=params, state=state or {}, **kw)


@pytest.mark.parametrize("size,k,stride,rate", [
    (512, 3, 2, 1), (513, 3, 2, 1), (64, 3, 1, 4), (17, 5, 2, 2), (8, 1, 1, 1)])
def test_padding_matches(size, k, stride, rate):
    assert padding.same_pads(size, k, stride, rate) == jpad.same_pads(
        size, k, stride, rate)
    assert padding.manual_pads(k, rate) == jpad.manual_pads(k, rate)
    p = padding.same_pads(size, k, stride, rate)
    assert padding.conv_out_size(size, k, stride, rate, p) == \
        jpad.conv_out_size(size, k, stride, rate, p)


def test_stem_pads_are_asymmetric():
    assert padding.same_pads(512, 3, 2) == (0, 1)


@pytest.mark.parametrize("hw,k,stride,rate,cin,cout", [
    (16, 3, 2, 1, 3, 8),     # the stem: stride-2 asymmetric SAME (0, 1)
    (15, 3, 2, 1, 4, 8),     # odd size: (1, 1)
    (12, 1, 1, 1, 16, 24),   # 1x1
    (12, 3, 1, 2, 8, 8),     # dilated
])
def test_conv2d_matches(hw, k, stride, rate, cin, cout):
    r = np.random.RandomState(0)
    x = r.randn(2, hw, hw, cin).astype(np.float32)
    w = (r.randn(k, k, cin, cout) * 0.3).astype(np.float32)
    ref = jconv.conv2d(_ctx({"c": {"kernel": jnp.asarray(w)}}),
                       jnp.asarray(x), cout, k, "c", stride=stride, rate=rate)
    got = conv.conv2d(_nchw(x), _to_port_layout("kernel", w), F32,
                      stride=stride, rate=rate)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("stride,rate", [(1, 1), (1, 2), (1, 4), (2, 1)])
def test_depthwise_conv2d_matches(stride, rate):
    r = np.random.RandomState(1)
    x = r.randn(2, 16, 16, 12).astype(np.float32)
    w = (r.randn(3, 3, 12, 1) * 0.3).astype(np.float32)
    ref = jconv.depthwise_conv2d(
        _ctx({"d": {"depthwise_kernel": jnp.asarray(w)}}), jnp.asarray(x), 3,
        "d", stride=stride, rate=rate)
    got = conv.depthwise_conv2d(_nchw(x), _to_port_layout(
        "depthwise_kernel", w), F32, stride=stride, rate=rate)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_mixed_conv_rounds_operands_to_bf16():
    """Under "mixed" the port rounds both conv operands to bf16 and runs the
    conv in f32 (JAX's DEFAULT-precision pass on the MXU).  JAX on the CPU
    ignores DEFAULT, so the reference is its f32 conv on operands rounded to
    bf16 by hand; the products are then exact and only the summation order
    differs (atol 1e-5)."""
    r = np.random.RandomState(2)
    x = r.randn(2, 16, 16, 8).astype(np.float32)
    w = (r.randn(3, 3, 8, 16) * 0.3).astype(np.float32)
    rb = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    ref = jconv.conv2d(_ctx({"c": {"kernel": jnp.asarray(rb(w))}}),
                       jnp.asarray(rb(x)), 16, 3, "c", stride=2)
    got = conv.conv2d(_nchw(x), _to_port_layout("kernel", w),
                      core.resolve_compute_dtype("mixed"), stride=2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_eval_batch_norm_matches(eps):
    r = np.random.RandomState(3)
    x = r.randn(2, 6, 6, 10).astype(np.float32)
    vals = {n: (r.rand(10) + 0.5).astype(np.float32)
            for n in ("gamma", "beta", "moving_mean", "moving_variance")}
    ctx = _ctx({"b": {"gamma": jnp.asarray(vals["gamma"]),
                      "beta": jnp.asarray(vals["beta"])}},
               {"b": {"moving_mean": jnp.asarray(vals["moving_mean"]),
                      "moving_variance": jnp.asarray(vals["moving_variance"])}})
    ref = jbn.batch_norm(ctx, jnp.asarray(x), "b", epsilon=eps)
    m = bn.BatchNorm(10, eps).eval()
    with torch.no_grad():
        for n, v in vals.items():
            getattr(m, n).copy_(torch.from_numpy(v))
    np.testing.assert_allclose(_nhwc(m(_nchw(x))), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((8, 8), (64, 64)), ((5, 7), (16, 13)),
                                     ((16, 16), (16, 16))])
def test_resize_bilinear_tf1_matches(src, dst):
    r = np.random.RandomState(4)
    x = r.randn(2, src[0], src[1], 3).astype(np.float32)
    ref = jresize.resize_bilinear_tf1(jnp.asarray(x), dst)
    got = resize.resize_bilinear_tf1(_nchw(x), dst)
    np.testing.assert_array_equal(resize._bilinear_matrix(src[0], dst[0]),
                                  jresize._bilinear_matrix(src[0], dst[0]))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
