"""The port's multi-scale and flip test-time augmentation (``Predictor``
``tta_scales`` / ``tta_flip``) against the JAX package's, on the CPU, in
float32, on the same weights; and the JAX test file's contracts
(tests/test_tta.py) on the port.  The 'subpixel' head and the Xception net
are held the same way in tests/test_torch_tta_heads.py (a file of its own,
so that the two run on separate test workers).

Weights.  MobileNetV2 'original': ``tests/data/mini_voc_trained.h5`` (3
classes) through both packages' loaders, served on four mini_voc tiles
resized to 64x64.  The 'subpixel' head and Xception at output stride 16:
the JAX net's initial trees with BN statistics calibrated through the port
on four tiles at 32x32 (as tests/test_torch_xception.py does: glorot weights
alone shrink the signal to nothing), the head's kernel scaled by 4 and
its bias centred on those tiles (so that the labels vary over an image),
carried back to JAX
with ``trees_from_net``, so both packages hold the same arrays; served on
two other tiles at 32x32.

Tolerances.  The JAX side's summed probabilities are rebuilt here from its
``SegNet.apply``, ``at_size`` and TF1 resize, in the JAX Predictor's order;
the port's (``Predictor._tta_probs``) must agree within 1e-5 a variant
(the two frameworks differ only in summation order through the nets).  The
labels of the two Predictors must be equal wherever the JAX averaged
probabilities' top-two margin exceeds 1e-4 (a closer call can go either way
on a summation-order difference).  With a CRF (the port's plane engine
against JAX ``backend="pallas"``), the raw labels by the same rule and the
refined masks on at least 0.99 of the pixels (tests/test_torch_predictor.py's
floor for the CRF configurations).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu.crf import CrfConfig as JCrfConfig
from deeplab_tpu.data.augment import resize_bilinear as jresize_cv
from deeplab_tpu.data.generator import _imread_bgr
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.ops.resize import resize_bilinear_tf1 as jresize
from deeplab_tpu.params import load_keras_h5 as jload
from deeplab_tpu.predictor import Predictor as JPredictor
from deeplab_tpu.viz import calculate_iou as jcalculate_iou

from deeplab_tpu_torch.crf import CrfConfig
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.params import (load_keras_h5, params_from_jax,
                                      trees_from_net)
from deeplab_tpu_torch.predictor import Predictor
from deeplab_tpu_torch.viz import calculate_iou

DATA = os.path.join(os.path.dirname(__file__), "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
SZ, XSZ = 64, 32
PROB_TOL, MARGIN, CRF_FLOOR = 1e-5, 1e-4, 0.99


def _calibrate(net, img, seed):
    """Seeded gamma/beta and BN moving statistics from the net's own input
    on one batch (variance times a seeded jitter, plus 0.1)."""
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


def _tiles(size, first, n):
    d = os.path.join(DATA, "mini_voc", "JPEGImages", "train")
    names = sorted(os.listdir(d))[first:first + n]
    return np.stack([jresize_cv(_imread_bgr(os.path.join(d, f)), (size,
                                                                  size))
                     for f in names]).astype(np.float32)


def _center_head(net, conv, img):
    """Scale the head's kernel by 4 and set its bias to minus each
    output's mean on ``img``: every class then wins somewhere (the
    calibrated trunk's features vary little about a large mean)."""
    seen = []
    hook = conv.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].float().mean(dim=(0, 2, 3))))
    net.eval().logits(img, "float32")
    hook.remove()
    with torch.no_grad():
        conv.kernel.mul_(4.0)
        conv.bias.copy_(-(conv.kernel[:, :, 0, 0] @ seen[0]))


@pytest.fixture(scope="module")
def tiles():
    return _tiles(SZ, 0, 4)


@pytest.fixture(scope="module")
def nets():
    """{kind: (JAX net, params, state, port net, n_classes, size)}."""
    jnet = JSegNet((SZ, SZ), 3, "mobilenetv2", "original")
    p, s = jload(H5, *jnet.init(jax.random.key(0)))
    return {"mobilenetv2": (jnet, p, s, load_keras_h5(
        H5, SegNet((SZ, SZ), 3)).eval(), 3, SZ)}


def calibrated_nets(kinds):
    """The 'subpixel' head and Xception at output stride 16, on calibrated
    JAX initial trees (the module docstring)."""
    out = {}
    img = torch.from_numpy(_tiles(XSZ, 4, 4))
    for kind, backbone, head, n in (("subpixel", "mobilenetv2", "subpixel",
                                     5),
                                    ("xception", "xception", "original", 5)):
        if kind not in kinds:
            continue
        jnet = JSegNet((XSZ, XSZ), n, backbone, head, OS=16)
        p0, s0 = jax.tree.map(np.asarray, jnet.init(jax.random.key(1)))
        net = params_from_jax(SegNet((XSZ, XSZ), n, backbone, head, OS=16),
                              p0, s0)
        _calibrate(net, img, 3)
        _center_head(net, net.conv_upsample if head == "original"
                     else net.subpixel, img)
        p, s = trees_from_net(net)
        out[kind] = (jnet, p, s, net.eval(), n, XSZ)
    return out


def _jax_tta_probs(jnet, params, state, imgs, scales, flip, n):
    """The JAX Predictor's summed probabilities, rebuilt from its SegNet:
    the same snapping, twins, flips, resizes and order of sums."""
    h, w = jnet.sz
    twins, seen = [], set()
    for s in scales:
        hs = max(8, int(round(h * s / 8.0)) * 8)
        ws = max(8, int(round(w * s / 8.0)) * 8)
        if (hs, ws) not in seen:
            seen.add((hs, ws))
            twins.append(jnet if (hs, ws) == (h, w) else jnet.at_size((hs,
                                                                      ws)))
    @jax.jit
    def summed(params, state, img):
        b = img.shape[0]
        acc = jnp.zeros((b, h, w, n), jnp.float32)
        for m in twins:
            im_s = img if m.sz == (h, w) else jresize(img, m.sz)
            for fl in ((False, True) if flip else (False,)):
                x = im_s[:, :, ::-1, :] if fl else im_s
                probs, _ = m.apply(params, state, x,
                                   compute_dtype=jnp.float32)
                probs = probs.reshape((b,) + m.sz + (n,))
                if fl:
                    probs = probs[:, :, ::-1, :]
                if m.sz != (h, w):
                    probs = jresize(probs, (h, w))
                acc = acc + probs
        return acc
    return (np.asarray(summed(params, state, jnp.asarray(imgs))),
            len(twins) * (2 if flip else 1))


def _images(kind, tiles):
    """The 64x64 tiles for the trained net, two other tiles at 32x32 for
    the calibrated ones."""
    return tiles if kind == "mobilenetv2" else _tiles(XSZ, 8, 2)


def _sure(acc, variants):
    top = np.sort(acc / variants, axis=-1)
    return top[..., -1] - top[..., -2] > MARGIN


def check_tta(nets, tiles, kind, scales, flip):
    """The summed probabilities, and the labels against the JAX Predictor's
    (its labels are the argmax of the rebuilt sums: checked on the first
    case, whose JAX Predictor compiles in seconds; the others hold the
    port's labels to that argmax)."""
    jnet, p, s, net, n, _ = nets[kind]
    imgs = _images(kind, tiles)
    want, variants = _jax_tta_probs(jnet, p, s, imgs, scales, flip, n)
    pred = Predictor(net, compute_dtype="float32", device="cpu",
                     tta_scales=scales, tta_flip=flip)
    assert len(pred.twins) * len(pred.flips) == variants
    with torch.inference_mode():
        got = pred._tta_probs(torch.from_numpy(imgs)).numpy()
    err = float(np.abs(got - want).max()) / variants
    print(f"{kind} {scales} flip={flip}: summed probabilities max "
          f"|port - JAX| / variants {err:.2e}")
    assert err <= PROB_TOL, err
    labels = pred(imgs)
    jlabels = want.argmax(-1)
    if (kind, scales) == ("mobilenetv2", (0.75, 1.0, 1.25)):
        np.testing.assert_array_equal(jlabels, np.asarray(JPredictor(
            jnet, p, s, crf=None, compute_dtype=jnp.float32,
            tta_scales=scales, tta_flip=flip)(imgs)))
    sure = _sure(want, variants)
    assert sure.mean() > 0.9 and len(np.unique(jlabels)) > 1
    np.testing.assert_array_equal(labels[sure], jlabels[sure])


@pytest.mark.parametrize("scales,flip", [
    ((0.75, 1.0, 1.25), True),
    ((0.97, 1.0, 1.25), False),      # 0.97 snaps onto 1.0
])
def test_tta_matches_jax(nets, tiles, scales, flip):
    check_tta(nets, tiles, "mobilenetv2", scales, flip)


def test_tta_with_crf_matches_jax(nets, tiles):
    jnet, p, s, net, n, _ = nets["mobilenetv2"]
    kw = dict(tta_scales=(0.75, 1.0), tta_flip=True)
    cfg = CrfConfig(sxy_bilateral=16.0, n_iters=2)
    raw, got = Predictor(net, crf=cfg, compute_dtype="float32", device="cpu",
                         return_raw=True, **kw)(tiles)
    jraw, want = JPredictor(jnet, p, s, crf=JCrfConfig(
        sxy_bilateral=16.0, n_iters=2, backend="pallas"),
        compute_dtype=jnp.float32, return_raw=True, **kw)(tiles)
    acc, variants = _jax_tta_probs(jnet, p, s, tiles, kw["tta_scales"], True,
                                   n)
    sure = _sure(acc, variants)
    np.testing.assert_array_equal(raw[sure], np.asarray(jraw)[sure])
    changed = float((np.asarray(jraw) != np.asarray(want)).mean())
    agree = float((got == np.asarray(want)).mean())
    print(f"TTA + CRF: mask agreement with JAX {agree:.5f} (its CRF changed "
          f"{changed:.4f} of the pixels)")
    assert changed > 0 and agree >= CRF_FLOOR, agree


def test_calculate_iou_through_tta_matches_jax(nets, tiles):
    """``viz.calculate_iou(predict_fn=Predictor(... tta ...))`` in both
    packages: the confusion matrices differ at most at the pixels whose
    top-two margin is within MARGIN (two cells each)."""
    jnet, p, s, net, n, _ = nets["mobilenetv2"]
    kw = dict(tta_scales=(0.75, 1.0), tta_flip=True)
    Y = np.random.RandomState(5).randint(0, n, (4, SZ * SZ, 1))

    class Gen:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return tiles[2 * i:2 * i + 2], Y[2 * i:2 * i + 2], {}

    conf, _, mean = calculate_iou(net, Gen(), n, predict_fn=Predictor(
        net, compute_dtype="float32", device="cpu", **kw))
    jconf, _, jmean = jcalculate_iou(jnet, p, s, Gen(), n,
                                     predict_fn=JPredictor(
                                         jnet, p, s, crf=None,
                                         compute_dtype=jnp.float32, **kw))
    acc, variants = _jax_tta_probs(jnet, p, s, tiles, kw["tta_scales"], True,
                                   n)
    unsure = int((~_sure(acc, variants)).sum())
    assert int(np.abs(conf - np.asarray(jconf)).sum()) <= 2 * unsure
    if unsure == 0:
        assert mean == pytest.approx(float(jmean), abs=1e-6)


# ---- tests/test_tta.py's contracts, on the port --------------------------

def _port_net(head="original"):
    return SegNet((XSZ, XSZ), 21, "mobilenetv2", head, seed=0)


def test_tta_identity_scale_matches_base():
    """scales=(1.0,), no flip, is exactly the argmax of ``apply``'s
    softmax (the probability path is TTA's identity contract)."""
    net = _port_net()
    imgs = np.random.RandomState(0).rand(2, XSZ, XSZ, 3) * 255
    probs = net.apply(torch.from_numpy(imgs).float(), "bfloat16")
    expected = probs.reshape(2, XSZ, XSZ, 21).argmax(-1).numpy()
    tta = Predictor(net, crf=None, compute_dtype="bfloat16", device="cpu",
                    tta_scales=(1.0,))
    np.testing.assert_array_equal(expected, tta(imgs))


def test_tta_flip_equivariance():
    """TTA over {identity, h-flip} is mirror-equivariant by construction."""
    net = _port_net()
    imgs = np.random.RandomState(1).rand(2, XSZ, XSZ, 3) * 255
    tta = Predictor(net, crf=None, device="cpu", tta_flip=True)
    a = tta(imgs)
    b = tta(np.ascontiguousarray(imgs[:, :, ::-1, :]))
    np.testing.assert_array_equal(a, b[:, :, ::-1])


def test_tta_dedupes_snapped_scales():
    """Scales that snap to the same multiple-of-8 size run once."""
    net = _port_net()
    imgs = np.random.RandomState(7).rand(2, XSZ, XSZ, 3) * 255
    a = Predictor(net, crf=None, device="cpu",
                  tta_scales=(0.97, 1.0, 0.5))(imgs)
    b = Predictor(net, crf=None, device="cpu", tta_scales=(1.0, 0.5))(imgs)
    np.testing.assert_array_equal(a, b)


def test_tta_multiscale_with_crf():
    imgs = np.random.RandomState(2).rand(2, XSZ, XSZ, 3) * 255
    tta = Predictor(_port_net(), crf=CrfConfig(sxy_bilateral=16.0,
                                               n_iters=2, backend="xla"),
                    device="cpu", tta_scales=(0.5, 1.0, 1.25), tta_flip=True)
    out = tta(imgs)
    assert out.shape == (2, XSZ, XSZ)
    assert out.dtype.kind == "i" and out.max() < 21


def test_tta_subpixel_head():
    imgs = np.random.RandomState(3).rand(1, XSZ, XSZ, 3) * 255
    out = Predictor(_port_net("subpixel"), crf=None, device="cpu",
                    tta_scales=(0.75, 1.0))(imgs)
    assert out.shape == (1, XSZ, XSZ) and out.max() < 21


def test_twins_share_the_weights():
    """``at_size`` twins hold the very tensors of the net: no copy."""
    net = _port_net()
    twin = net.at_size((24, 40))
    assert twin.sz == (24, 40) and net.sz == (XSZ, XSZ)
    pairs = zip(net.state_dict(keep_vars=True).values(),
                twin.state_dict(keep_vars=True).values())
    assert all(a is b for a, b in pairs)


def test_calculate_iou_predict_fn_matches_default():
    """A scale-1.0 float32 TTA Predictor is the argmax of ``apply``'s f32
    softmax, so the whole confusion matrix must match that forward's."""
    net = _port_net()
    rng = np.random.RandomState(5)
    X = rng.rand(4, XSZ, XSZ, 3).astype(np.float32) * 255
    Y = rng.randint(0, 21, (4, XSZ * XSZ, 1)).astype(np.float32)

    class Gen:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return X[2 * i:2 * i + 2], Y[2 * i:2 * i + 2], {}

    def forward_argmax(x):
        return net.apply(torch.from_numpy(np.asarray(x, np.float32)),
                         "float32").argmax(-1)

    conf0, _, m0 = calculate_iou(net, Gen(), 21, predict_fn=forward_argmax)
    tta = Predictor(net, crf=None, compute_dtype="float32", device="cpu",
                    tta_scales=(1.0,))
    conf1, _, m1 = calculate_iou(net, Gen(), 21, predict_fn=tta)
    np.testing.assert_array_equal(conf0, conf1)
    assert m0 == m1


def test_tta_rejects_spatial_sharding():
    with pytest.raises(ValueError):
        Predictor(_port_net(), device="cpu", spatial=True,
                  tta_scales=(0.5, 1.0))
