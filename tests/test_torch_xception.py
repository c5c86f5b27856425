"""The port's Xception SegNet against the JAX SegNet on the CPU, at 32x32,
full width, output stride 16 and 8, with the 'original' and 'subpixel'
heads.

Weights: the JAX net's own initial trees (output stride changes no shape,
so one init serves both), the subpixel conv from JAX's ICNR, and BN
statistics from one seeded batch at each output stride (each BN's moving
statistics are its own input's, layer by layer, the variance times a seeded
jitter plus 0.1, with seeded gamma and beta): glorot weights alone shrink
the signal to ~1e-6 through the 60-odd layers, and the floor keeps a channel
that is nearly constant on the batch (the middle flow's maps are 2x2 here)
from amplifying rounding differences.  The calibrated trees go back through
``params_from_jax`` (strict) into every port net and into JAX unchanged.

Tolerances.  float32: the two frameworks differ only in summation order:
1e-4 of the largest |logit|.  "mixed": the port rounds each matmul operand
to bf16 as the TPU's single MXU pass does, and its eval-mode stride-1
SepConvs take ``fused_sepconv`` (on the CPU its plain version); JAX on the
CPU computes "mixed" in full f32 (its logits equal its f32 logits), so it
cannot be the yardstick.  The port's own "mixed" layer composition
(``fuse_blocks=False``) is: the kernel path may be at most 1.5x as far from
JAX f32 as the composition is.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.ops import init as jinit

from deeplab_tpu_torch import Predictor, crf
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.params import params_from_jax, trees_from_net
from deeplab_tpu_torch.train import Trainer

SZ, N_CLS = 32, 5
CASES = [(16, "original"), (16, "subpixel"), (8, "original"), (8, "subpixel")]
SEPCONVS = {16: 65, 8: 66}   # eval-mode stride-1 SepConv_BNs per forward


def _head(trees, head):
    """The trees without the other head's layer."""
    drop = "conv_upsample" if head == "subpixel" else "subpixel"
    return {k: v for k, v in trees.items() if k != drop}


def _calibrate(net, img, seed):
    r = np.random.RandomState(seed)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    jitter = {}
    with torch.no_grad():
        for bn in bns:
            c = bn.gamma.shape[0]
            bn.gamma.copy_(torch.from_numpy(0.5 + r.rand(c).astype(np.float32)))
            bn.beta.copy_(torch.from_numpy(r.rand(c).astype(np.float32) - 0.5))
            jitter[bn] = torch.from_numpy(0.8 + 0.4 * r.rand(c).astype(
                np.float32))

    def hook(bn, args):
        x = args[0].float()
        bn.moving_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.moving_variance.copy_(x.var(dim=(0, 2, 3), unbiased=False)
                                 * jitter[bn] + 0.1)
    hooks = [bn.register_forward_pre_hook(hook) for bn in bns]
    net.eval().logits(img, "float32")
    for h in hooks:
        h.remove()


@pytest.fixture(scope="module")
def images():
    return (np.random.RandomState(0).rand(2, SZ, SZ, 3) * 255).astype(
        np.float32)


@pytest.fixture(scope="module")
def trees(images):
    """``(layer_order, {OS: (params, state)})``."""
    jnet = JSegNet((SZ, SZ), N_CLS, "xception", "original", OS=16)
    p0, s0 = jax.tree.map(np.asarray, jnet.init(jax.random.key(0)))
    sub = {"kernel": np.asarray(jinit.icnr(jax.random.key(1),
                                           (1, 1, 256, N_CLS * 16), 4)),
           "bias": (np.random.RandomState(2).randn(N_CLS * 16) * 0.1
                    ).astype(np.float32)}
    out = {}
    for OS in (16, 8):
        net = params_from_jax(SegNet((SZ, SZ), N_CLS, "xception", OS=OS),
                              p0, s0)
        _calibrate(net, torch.from_numpy(images), 1)
        p, s = trees_from_net(net)
        p["subpixel"] = sub
        out[OS] = p, s
    return jnet.layer_order, out


@pytest.fixture(scope="module")
def jax_logits(trees, images):
    out = {}
    for OS, head in CASES:
        p, s = trees[1][OS]
        jnet = JSegNet((SZ, SZ), N_CLS, "xception", head, OS=OS)
        out[OS, head] = np.asarray(jnet.apply_logits(
            _head(p, head), s, jnp.asarray(images),
            compute_dtype=jnp.float32)[0])
    return out


@pytest.fixture(scope="module")
def port(trees):
    """One port net per (OS, head), loaded strictly from the trees; tests
    that switch ``fuse_blocks`` or the mode put them back."""
    out = {}
    for OS, head in CASES:
        p, s = trees[1][OS]
        out[OS, head] = params_from_jax(
            SegNet((SZ, SZ), N_CLS, "xception", head, OS=OS), _head(p, head),
            s).eval()
    return out


def test_layer_order_and_trees_match_jax(trees, port):
    order, (p, s) = trees[0], trees[1][16]
    assert len(order) == 293 and order[-1] == "conv_upsample"
    for head in ("original", "subpixel"):
        net = port[16, head]
        want = order[:-1] + ((order[-1],) if head == "original"
                             else ("subpixel",))
        assert net.layer_order == want
        tp, ts = trees_from_net(net)
        assert tp.keys() == _head(p, head).keys() and ts.keys() == s.keys()
        for layer, vars_ in ts.items():
            for var, v in vars_.items():
                np.testing.assert_array_equal(v, s[layer][var])


@pytest.mark.parametrize("OS,head", CASES)
def test_f32_logits_match_jax(port, jax_logits, images, OS, head):
    want = jax_logits[OS, head]
    got = port[OS, head].logits(torch.from_numpy(images), "float32").numpy()
    assert got.shape == want.shape == (2, SZ, SZ, N_CLS)
    scale = np.abs(want).max()
    assert scale > 0.1       # calibrated: logits well away from 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("OS,head", CASES)
def test_mixed_kernel_path_within_composition_yardstick(port, jax_logits,
                                                        images, OS, head):
    want = jax_logits[OS, head]
    x = torch.from_numpy(images)
    net = port[OS, head]
    fused = net.logits(x, "mixed").numpy()
    net.fuse_blocks = False
    try:
        plain = net.logits(x, "mixed").numpy()
    finally:
        net.fuse_blocks = True
    err_k = np.abs(fused - want).max()
    err_c = np.abs(plain - want).max()
    print(f"OS {OS} {head}: max|logit| {np.abs(want).max():.4f}; mixed vs "
          f"JAX f32: kernel path {err_k:.4e}, composition {err_c:.4e}")
    assert 0 < err_k <= 1.5 * err_c


@pytest.mark.parametrize("OS", [16, 8])
def test_gate_engages_on_every_stride1_sepconv(port, images, monkeypatch,
                                               OS):
    calls = {"sepconv": 0, "mbconv": 0}
    real_s, real_m = FM.fused_sepconv, FM.fused_mbconv

    def spy_s(*a, **k):
        calls["sepconv"] += 1
        return real_s(*a, **k)

    def spy_m(*a, **k):
        calls["mbconv"] += 1
        return real_m(*a, **k)
    monkeypatch.setattr(FM, "fused_sepconv", spy_s)
    monkeypatch.setattr(FM, "fused_mbconv", spy_m)
    net = port[OS, "original"]
    # the count does not depend on the input's size: one 16x16 image
    x = torch.from_numpy(np.ascontiguousarray(images[:1, ::2, ::2]))

    def count(fn):
        calls.update(sepconv=0, mbconv=0)
        fn()
        return calls["sepconv"], calls["mbconv"]
    assert count(lambda: net.logits(x, "mixed")) == (SEPCONVS[OS], 0)
    assert count(lambda: net.logits(x, "bfloat16")) == (SEPCONVS[OS], 0)
    assert count(lambda: net.logits(x, "float32")) == (0, 0)
    # a training forward updates the moving statistics: put them back
    stats = {n: b.clone() for n, b in net.named_buffers()}
    try:
        net.train()
        assert count(lambda: net.apply_logits(
            x, "mixed", torch.Generator().manual_seed(0))) == (0, 0)
        net.eval().fuse_blocks = False
        assert count(lambda: net.logits(x, "mixed")) == (0, 0)
    finally:
        net.eval().fuse_blocks = True
        with torch.no_grad():
            for n, b in net.named_buffers():
                b.copy_(stats[n])
    assert real_s.launches == 0     # the CPU launches no kernel


def test_predictor_with_crf_serves_xception_unchanged():
    """The CRF is net-agnostic: the production Predictor serves an Xception
    net as it serves MobileNetV2 (here on the CPU, seeded weights)."""
    net = SegNet((128, 128), 3, "xception", "subpixel", OS=16)
    img = np.random.RandomState(3).rand(1, 128, 128, 3) * 255
    raw, refined = Predictor(net, crf=crf.PRODUCTION_CONFIG, device="cpu",
                             return_raw=True)(img)
    assert raw.shape == refined.shape == (1, 128, 128)
    for m in (raw, refined):
        assert m.dtype == np.int32 and m.min() >= 0 and m.max() < 3


@pytest.mark.parametrize("backbone,head", [("xception", "original"),
                                           ("mobilenetv2", "subpixel")])
def test_trainer_refuses_xception_and_subpixel(port, backbone, head):
    net = (port[16, "original"] if backbone == "xception"
           else SegNet((32, 32), 3, backbone, head, alpha=0.35))
    with pytest.raises(NotImplementedError, match="A8"):
        Trainer(net, device="cpu")


@pytest.mark.parametrize("kw", [dict(backbone="resnet"), dict(net="deconv"),
                                dict(backbone="xception", OS=32)])
def test_unknown_backbone_head_or_stride_raises(kw):
    with pytest.raises(ValueError):
        SegNet((32, 32), 3, **kw)
