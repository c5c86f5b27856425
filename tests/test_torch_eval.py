"""The port's evaluation surface against the JAX package, on the CPU: the
metrics of ``metrics.py`` on random ids (confusion matrices and per-class
IoU exact; a mean over classes or pixels within 2 f32 ulps, as the two sum
in another order), ``viz.mIOU``, and
``viz.calculate_iou`` on the ``tests/data/mini_voc`` tiles at their own
128x128 size with ``tests/data/mini_voc_trained.h5``.

At float32 the port's masks equal JAX's on every pixel of the tiles (the
logits differ by summation order only), so the confusion matrices must be
identical and the published means equal to 2 f32 ulps.  Through a CRF
``Predictor`` at ``CrfConfig(backend="xla")`` on both sides the engines
differ by bf16 rounding, so the published means are held within 0.01.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deeplab_tpu import metrics as JM
from deeplab_tpu import viz as JV
from deeplab_tpu.crf import CrfConfig as JCrfConfig
from deeplab_tpu.data.generator import _imread_bgr, _imread_gray
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload
from deeplab_tpu.predictor import Predictor as JPredictor

from deeplab_tpu_torch import metrics as TM
from deeplab_tpu_torch import viz as TV
from deeplab_tpu_torch.crf import CrfConfig
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_keras_h5
from deeplab_tpu_torch.predictor import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
SZ, N_CLS = 128, 3
ULPS2 = 2 * 2.0 ** -23       # a mean summed in another order


def _ids(seed, n_classes, shape=(3, 50)):
    """Random labels with void pixels (label == n_classes) and predictions."""
    r = np.random.RandomState(seed)
    return (r.randint(0, n_classes + 1, shape).astype(np.int32),
            r.randint(0, n_classes, shape).astype(np.int32))


@pytest.mark.parametrize("ref_shift", [False, True])
@pytest.mark.parametrize("n", [3, 21])
def test_confusion_metrics_match_jax(n, ref_shift):
    labels, preds = _ids(n, n)
    got = TM.confusion_matrix(torch.from_numpy(labels),
                              torch.from_numpy(preds), n, ref_shift)
    want = np.asarray(JM.confusion_matrix(jnp.asarray(labels),
                                          jnp.asarray(preds), n, ref_shift))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == int((labels < n).sum())   # voids left out
    np.testing.assert_array_equal(
        TM.iou_from_confusion(got).numpy(),
        np.asarray(JM.iou_from_confusion(jnp.asarray(want))))
    np.testing.assert_allclose(
        TM.mean_iou_published(got).numpy(),
        np.asarray(JM.mean_iou_published(jnp.asarray(want))), rtol=ULPS2)


def test_step_metrics_match_jax():
    r = np.random.RandomState(4)
    y_true = r.randint(0, 6, (2, 40, 1)).astype(np.int32)  # 5 = void
    y_pred = r.rand(2, 40, 5).astype(np.float32)
    acc = TM.sparse_accuracy_ignoring_last_label(torch.from_numpy(y_true),
                                                 torch.from_numpy(y_pred))
    np.testing.assert_allclose(acc.numpy(), np.asarray(
        JM.sparse_accuracy_ignoring_last_label(jnp.asarray(y_true),
                                               jnp.asarray(y_pred))),
        rtol=ULPS2)
    jac = TM.Jaccard(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    np.testing.assert_allclose(jac.numpy(), np.asarray(
        JM.Jaccard(jnp.asarray(y_true), jnp.asarray(y_pred))), rtol=ULPS2)


def test_miou_matches_jax():
    labels, preds = _ids(7, 4, (16, 16))
    assert TV.mIOU(labels, preds) == JV.mIOU(labels, preds)
    assert TV.mIOU(labels, labels) == 1.0


class Tiles:
    """The mini_voc tiles in batches of 4 as ``(X, Y, None)``: X (B, H, W,
    3) BGR, Y (B, H*W, 1) ids; a few label pixels void (== 3)."""

    def __init__(self, n):
        d = os.path.join(DATA, "mini_voc")
        names = sorted(os.listdir(os.path.join(d, "JPEGImages", "train")))[:n]
        self.X = np.stack([_imread_bgr(os.path.join(d, "JPEGImages", "train",
                                                    f)) for f in names])
        Y = np.stack([_imread_gray(os.path.join(
            d, "SegmentationClassAug", f[:-4] + ".png")) for f in names])
        Y = Y.astype(np.int32)
        Y[:, :4, :4] = N_CLS
        self.Y = Y.reshape(len(names), -1, 1)

    def __len__(self):
        return len(self.X) // 4

    def __getitem__(self, i):
        s = slice(4 * i, 4 * i + 4)
        return self.X[s].astype(np.float32), self.Y[s], None


@pytest.fixture(scope="module")
def nets():
    jnet = JSegNet((SZ, SZ), N_CLS, "mobilenetv2", "original")
    params, state = jload(H5, *jnet.init(jax.random.key(0)))
    tnet = load_keras_h5(H5, SegNet((SZ, SZ), N_CLS)).eval()
    return jnet, params, state, tnet


def test_calculate_iou_matches_jax_at_f32(nets):
    jnet, params, state, tnet = nets
    gen = Tiles(12)
    for ref_shift in (True, False):
        want = JV.calculate_iou(jnet, params, state, gen, N_CLS, ref_shift)
        got = TV.calculate_iou(
            tnet, gen, N_CLS, ref_shift,
            predict_fn=lambda X: tnet.predict_ids(torch.from_numpy(X),
                                                  "float32"))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == pytest.approx(want[2], rel=ULPS2, abs=0)
    assert got[0].sum() == (gen.Y < N_CLS).sum()
    print(f"published mean IoU {got[2]:.5f}")
    # the default predict_fn: the forward argmax under "mixed"
    mixed = TV.calculate_iou(tnet, gen, N_CLS)
    assert abs(mixed[2] - want[2]) <= 0.01


def test_calculate_iou_through_the_xla_crf_matches_jax(nets):
    jnet, params, state, tnet = nets
    gen = Tiles(8)
    jpred = JPredictor(jnet, params, state, crf=JCrfConfig(backend="xla"),
                       compute_dtype=jnp.float32)
    want = JV.calculate_iou(jnet, params, state, gen, N_CLS,
                            predict_fn=lambda X: np.asarray(jpred(X)))
    tpred = Predictor(tnet, crf=CrfConfig(backend="xla"),
                      compute_dtype="float32", device="cpu")
    got = TV.calculate_iou(tnet, gen, N_CLS, predict_fn=tpred)
    raw = TV.calculate_iou(
        tnet, gen, N_CLS,
        predict_fn=lambda X: tnet.predict_ids(torch.from_numpy(X),
                                              "float32"))
    print(f"published mean IoU: port {got[2]:.5f}, JAX {want[2]:.5f}; "
          f"without the CRF {raw[2]:.5f}")
    assert not np.array_equal(got[0], raw[0])      # the CRF moved pixels
    assert abs(got[2] - want[2]) <= 0.01


def test_viz_imports_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import deeplab_tpu_torch.viz as v; "
            "assert v.colorize_mask([[0, 1]]).shape == (1, 2, 3)")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_palette_and_colorize_match_jax():
    np.testing.assert_array_equal(TV.voc_palette(), JV.voc_palette())
    m = np.random.RandomState(8).randint(0, 300, (5, 7))
    np.testing.assert_array_equal(TV.colorize_mask(m), JV.colorize_mask(m))
