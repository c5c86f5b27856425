"""``Predictor.predict_files`` of the port (streamed file serving) and the
host helpers it calls, against the JAX package on the CPU: the mirror of
tests/test_predict_files.py without its sharded case.

The copied resizes (``data/augment.py``) and image readers
(``data/generator.py``) must give JAX's bytes exactly.  JAX routes uint8
resizes through its native library where that is built; the port keeps
the numpy path, so the exact comparisons switch the native library off.
With it on, the bilinear resize differs from the numpy path by one level
on a handful of rounding ties (at 375x500 -> 512x512 one value in ~260 k)
and agrees everywhere else; ``test_native_resize_differs_by_at_most_one``
pins that.

Masks against JAX: float32, the 3-class ``mini_voc_trained.h5`` in both
packages at 64x64 on mini_voc tiles; agreement at least 0.999
(tests/test_torch_predictor.py's float32 floor: the logits differ only by
summation order).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from deeplab_tpu.data import augment as JA
from deeplab_tpu.data import generator as JG
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload
from deeplab_tpu.predictor import Predictor as JPredictor

from deeplab_tpu_torch.crf import CrfConfig
from deeplab_tpu_torch.data import augment as A
from deeplab_tpu_torch.data.generator import _imread_bgr, _imread_gray
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_keras_h5
from deeplab_tpu_torch.predictor import Predictor

SZ = 32
H5 = os.path.join(os.path.dirname(__file__), "data", "mini_voc_trained.h5")
F32_FLOOR = 0.999


@pytest.fixture
def numpy_path(monkeypatch):
    """JAX's resizes on their numpy path (the native library off)."""
    monkeypatch.setattr(JA._native, "available", lambda: False)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    paths = []
    for i, size in enumerate([(SZ, SZ), (SZ, SZ), (48, 40), (SZ, SZ),
                              (24, 56)]):
        arr = rng.randint(0, 255, size + (3,), dtype=np.uint8)
        p = d / f"im{i}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    return paths


def _expected_batch(paths):
    return np.stack([A.resize_bilinear(_imread_bgr(p), (SZ, SZ))
                     for p in paths]).astype(np.float32)


def _pred(**kw):
    return Predictor(SegNet((SZ, SZ), 21), device="cpu", **kw)


def test_predict_files_matches_call(image_files):
    pred = _pred(crf=None)
    got = dict(pred.predict_files(image_files, batch_size=2, workers=2))
    assert list(got) == image_files  # input order preserved
    want = pred(_expected_batch(image_files))
    for i, p in enumerate(image_files):
        np.testing.assert_array_equal(got[p], want[i])


def test_predict_files_workers_zero(image_files):
    """A worker count that bottoms out at 0 is clamped, not a crash."""
    got = dict(_pred(crf=None).predict_files(image_files[:2], batch_size=2,
                                             workers=0))
    assert list(got) == image_files[:2]


def test_predict_files_return_raw_and_ragged(image_files):
    pred = _pred(return_raw=True, crf=CrfConfig(sxy_bilateral=16.0,
                                                n_iters=1, backend="xla"))
    # batch_size larger than the file count: one padded batch
    out = list(pred.predict_files(image_files, batch_size=8))
    assert len(out) == len(image_files)
    raw_b, ref_b = pred(_expected_batch(image_files))
    for i, (p, (raw, ref)) in enumerate(out):
        np.testing.assert_array_equal(raw, raw_b[i])
        np.testing.assert_array_equal(ref, ref_b[i])


@pytest.mark.parametrize("batch_size", [2, 8])
def test_predict_files_matches_jax(batch_size, numpy_path):
    """The two packages' predict_files on the same files (five mini_voc
    tiles, 128x128 JPEGs, served at 64x64) and weights."""
    d = os.path.join(os.path.dirname(__file__), "data", "mini_voc",
                     "JPEGImages", "train")
    files = [os.path.join(d, f) for f in sorted(os.listdir(d))[:5]]
    jnet = JSegNet((2 * SZ, 2 * SZ), 3, "mobilenetv2", "original")
    params, state = jload(H5, *jnet.init(jax.random.key(0)))
    want = dict(JPredictor(jnet, params, state, crf=None,
                           compute_dtype=jnp.float32).predict_files(
        files, batch_size=batch_size))
    got = dict(Predictor(load_keras_h5(H5, SegNet((2 * SZ, 2 * SZ), 3)),
                         compute_dtype="float32", device="cpu").predict_files(
        files, batch_size=batch_size))
    assert list(got) == list(want) == files
    masks = np.stack([got[p] for p in files])
    jmasks = np.stack([np.asarray(want[p]) for p in files])
    assert len(np.unique(jmasks)) > 1
    agree = float((masks == jmasks).mean())
    assert agree >= F32_FLOOR, agree


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size_in,size_wh", [
    ((40, 44), (32, 32)), ((128, 128), (64, 64)), ((48, 40), (32, 32)),
    ((24, 56), (32, 32)), ((33, 17), (100, 70)), ((375, 500), (512, 512)),
    ((32, 32), (32, 32))])
def test_resizes_match_jax(size_in, size_wh, dtype, numpy_path):
    rng = np.random.RandomState(size_in[0] + size_wh[0])
    for shape in (size_in + (3,), size_in):
        img = (rng.rand(*shape) * 255).astype(dtype)
        got = A.resize_bilinear(img, size_wh)
        want = JA.resize_bilinear(img, size_wh)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(A.resize_nearest(img, size_wh),
                                      JA.resize_nearest(img, size_wh))


def test_native_resize_differs_by_at_most_one():
    """Where JAX's native library is built, its uint8 bilinear resize is
    the numpy path's to within one level (rounding ties)."""
    img = np.random.RandomState(0).randint(0, 256, (375, 500, 3), np.uint8)
    got = A.resize_bilinear(img, (512, 512)).astype(np.int16)
    want = JA.resize_bilinear(img, (512, 512)).astype(np.int16)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


def test_image_readers_match_jax(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(3)
    rgb = tmp_path / "im.png"
    Image.fromarray(rng.randint(0, 256, (20, 30, 3), np.uint8)).save(rgb)
    gray = tmp_path / "lab.png"
    Image.fromarray(rng.randint(0, 21, (20, 30), np.uint8), mode="L").save(
        gray)
    pal = tmp_path / "pal.png"
    im = Image.fromarray(rng.randint(0, 21, (20, 30), np.uint8), mode="P")
    im.putpalette(list(rng.randint(0, 256, 768)))
    im.save(pal)
    np.testing.assert_array_equal(_imread_bgr(str(rgb)),
                                  JG._imread_bgr(str(rgb)))
    for p in (gray, pal, rgb):
        np.testing.assert_array_equal(_imread_gray(str(p)),
                                      JG._imread_gray(str(p)))
