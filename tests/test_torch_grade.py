"""The port's production grade (deeplab_tpu_torch/grade.py) against the JAX
repo's tools/grade_production.py, on the CPU.

- The scoring helpers (per-image confusion, the published mean with its
  (-1, -1) roll, standard mIoU, the bootstrap CI of the delta) are copies:
  on the same seeded labels and confusions they give equal results, the CI
  at the same seed included.
- The tiles: ``_load_tiles`` at 64x64 on both splits, bit for bit.
- The weights: the port's net from ``mini_voc_trained.npz`` holds the arrays
  of JAX's strict load of ``mini_voc_trained.h5``, exactly, and that load
  skipped no depthwise kernel (ROADMAP C1 concerns another file).
- The masks: both stacks at 64x64 on four select tiles against JAX
  ``Predictor``s built as ``grade()`` builds them, with the CRF forced to
  JAX's plane engine (``backend="pallas"``, interpret mode; on the CPU
  "auto" picks the XLA engine, whose square cells legitimately differ).
  Agreement >= 0.995 (the CPU CRF floor): float32 logits differ by
  summation order only; under "mixed" the port rounds conv operands to
  bf16 where JAX on the CPU computes in f32, and the trained net's margins
  absorb that.
- ``grade()`` refuses to run without a card unless asked for the CPU.

The module runs on one torch thread (the suite's workers share the cores).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import grade_production as J  # noqa: E402
from deeplab_tpu import crf as JCRF  # noqa: E402
from deeplab_tpu.models.seg_model import SegNet as JSegNet  # noqa: E402
from deeplab_tpu.params import load_keras_h5 as jload_h5  # noqa: E402
from deeplab_tpu.predictor import Predictor as JPredictor  # noqa: E402

from deeplab_tpu_torch import grade as G  # noqa: E402
from deeplab_tpu_torch.data import native as port_native  # noqa: E402
from deeplab_tpu_torch.models.seg_model import SegNet  # noqa: E402
from deeplab_tpu_torch.params import params_from_jax  # noqa: E402

SZ = 64
N_TILES = 4
MASK_FLOOR = 0.995


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels_preds(seed, n=6, hw=(40, 56), n_classes=G.N_CLASSES):
    r = np.random.RandomState(seed)
    labels = r.randint(0, n_classes, (n,) + hw).astype(np.int32)
    labels[r.rand(n, *hw) < 0.1] = 255          # void pixels
    preds = r.randint(0, n_classes, (n,) + hw).astype(np.int32)
    return labels, preds


def test_constants_name_the_same_data():
    assert G.N_CLASSES == J.N_CLASSES
    assert G.DATA_SELECT == J.DATA_SELECT and G.DATA_EVAL == J.DATA_EVAL
    # the card has no h5py: the port reads the same weights as .npz
    assert G.WEIGHTS == os.path.splitext(J.WEIGHTS)[0] + ".npz"
    assert os.path.exists(G.WEIGHTS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scoring_helpers_equal_jax(seed):
    labels, preds = _labels_preds(seed)
    conf = G._per_image_conf(labels, preds, G.N_CLASSES)
    want = J._per_image_conf(labels, preds, J.N_CLASSES)
    assert conf.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(conf, want)
    total = conf.sum(0)
    assert G._published(total) == J._published(total)
    assert G._std_miou(total) == J._std_miou(total)
    # a class absent from labels and predictions (empty row and column)
    total[1, :] = total[:, 1] = 0
    assert G._published(total) == J._published(total)
    assert G._std_miou(total) == J._std_miou(total)


@pytest.mark.parametrize("seed", [0, 7])
def test_bootstrap_ci_equals_jax_at_the_same_seed(seed):
    labels, preds = _labels_preds(seed, n=12)
    _, preds2 = _labels_preds(seed + 100, n=12)
    par = G._per_image_conf(labels, preds, G.N_CLASSES)
    pro = G._per_image_conf(labels, preds2, G.N_CLASSES)
    got = G._bootstrap_ci(par, pro, n_boot=300, seed=seed)
    assert got == J._bootstrap_ci(par, pro, n_boot=300, seed=seed)
    assert got != G._bootstrap_ci(par, pro, n_boot=300, seed=seed + 1)


@pytest.mark.parametrize("split", ["select", "eval"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_tiles_equal_jax(split, native, monkeypatch):
    data = G.DATA_EVAL if split == "eval" else G.DATA_SELECT
    if not native:
        # both packages' numpy resizes
        from deeplab_tpu.data import native as jax_native
        monkeypatch.setattr(jax_native, "available", lambda: False)
        with port_native.masked():
            X, Y = G._load_tiles((SZ, SZ), data)
    else:
        X, Y = G._load_tiles((SZ, SZ), data)
    JX, JY = J._load_tiles((SZ, SZ), data)
    assert X.shape == (64 if split == "eval" else 20, SZ, SZ, 3)
    assert X.dtype == JX.dtype == np.float32
    assert Y.dtype == JY.dtype == np.int32
    np.testing.assert_array_equal(X, JX)
    np.testing.assert_array_equal(Y, JY)


@pytest.fixture(scope="module")
def jax_net():
    """JAX's net as its grade() builds it: (net, initial trees, loaded
    trees)."""
    net = JSegNet((SZ, SZ), J.N_CLASSES, "mobilenetv2", "original")
    init = net.init(jax.random.key(0))
    return net, init, jload_h5(J.WEIGHTS, *init, strict=True)


def test_npz_weights_equal_jax_strict_h5_load(jax_net):
    _, init, (jparams, jstate) = jax_net
    # JAX's loader skipped no depthwise kernel of this file (C1 is the
    # Keras-3 subpixel file's): each differs from its initial value
    dw = [k for k, v in jparams.items() if "depthwise_kernel" in v]
    assert len(dw) == 17
    for k in dw:
        assert not np.array_equal(np.asarray(jparams[k]["depthwise_kernel"]),
                                  np.asarray(init[0][k]["depthwise_kernel"])), k
    want = params_from_jax(SegNet((SZ, SZ), 3, seed=5), jparams, jstate)
    got = G._net((SZ, SZ))
    sa, sb = got.state_dict(), want.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def tiles():
    return J._load_tiles((SZ, SZ), J.DATA_SELECT)[0][:N_TILES]


@pytest.fixture(scope="module")
def jax_masks(tiles, jax_net):
    """JAX's two stacks as its grade() builds them, the CRF on its plane
    engine: {stack: (raw labels, masks)}."""
    net, _, (params, state) = jax_net
    par = dataclasses.replace(JCRF.CrfConfig(), backend="pallas")
    pro = dataclasses.replace(JCRF.PRODUCTION_CONFIG, backend="pallas")
    return {"parity": JPredictor(net, params, state, crf=par,
                                 compute_dtype=jnp.float32,
                                 return_raw=True)(tiles),
            "production": JPredictor(net, params, state, crf=pro,
                                     compute_dtype="mixed",
                                     return_raw=True)(tiles)}


@pytest.mark.parametrize("stack", ["parity", "production"])
def test_stack_masks_match_jax(stack, tiles, jax_masks):
    stacks = G._stacks(G._net((SZ, SZ)), device="cpu")
    masks, launches = G._serve(stacks[stack], tiles, 2)
    assert masks.shape == (N_TILES, SZ, SZ) and masks.dtype == np.int32
    assert launches == [{}, {}]        # no kernel launch on the CPU
    raw, want = jax_masks[stack]
    assert (want != raw).mean() > 0       # the CRF moved some pixels
    agree = float((masks == want).mean())
    print(f"{stack} masks against JAX's plane engine: {agree:.5f}")
    assert agree >= MASK_FLOOR, agree


def test_stacks_are_the_graded_policies():
    stacks = G._stacks(G._net((SZ, SZ)), device="cpu")
    par, pro = stacks["parity"], stacks["production"]
    assert par.policy.dtype == torch.float32 and not par.policy.mxu_bf16
    assert pro.policy.dtype == torch.float32 and pro.policy.mxu_bf16
    from deeplab_tpu_torch.crf import PRODUCTION_CONFIG, CrfConfig
    assert par.crf == CrfConfig() and pro.crf == PRODUCTION_CONFIG
    assert G._crf_tag(pro.crf) == J._crf_tag(JCRF.PRODUCTION_CONFIG)
    assert G._crf_tag(par.crf) == J._crf_tag(JCRF.CrfConfig())


def test_grade_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.grade(size=(SZ, SZ))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.grade(size=(SZ, SZ), device="cuda")


def test_shortfall_is_the_criterion():
    rec = {"delta_published_pt": 0.05, "delta_std_pt": -0.12}
    assert G.shortfall(rec) == 0.12
    assert G.shortfall({"delta_published_pt": 0.2,
                        "delta_std_pt": 0.0}) == 0.0


@pytest.mark.slow
def test_grade_production_record():
    """The port's twin of tests/test_production_miou.py: the select split
    at 128x128 on the CPU, both stacks, the record's fields."""
    rec = G.grade(size=(128, 128), batch=4, split="select", device="cpu")
    jrec_keys = ("miou_published_parity", "miou_published_production",
                 "delta_published_pt", "ci95_delta_published_pt",
                 "miou_std_parity", "miou_std_production", "delta_std_pt",
                 "images", "split", "size", "production_policy",
                 "fused_kernels_available")
    assert sorted(rec) == sorted(jrec_keys)
    assert rec["images"] == 20 and rec["split"] == "select"
    assert rec["size"] == "128x128"
    assert rec["production_policy"] == "mixed+cs1.5nnlsst2"
    assert rec["fused_kernels_available"] is False
    assert 0.0 < rec["miou_published_parity"] <= 1.0
    assert 0.0 < rec["miou_published_production"] <= 1.0
    lo, hi = rec["ci95_delta_published_pt"]
    assert lo <= rec["delta_published_pt"] <= hi
    assert G.shortfall(rec) < 2.0, rec
