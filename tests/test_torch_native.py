"""The port's native host image library (``data/csrc/imgops.cpp`` through
``deeplab_tpu_torch/data/native.py``) on the CPU.

- Each op against the port's numpy path (``native.masked()``), with
  tests/test_native.py's tolerances.
- Each op against the JAX package's library (``deeplab_tpu.data.native``,
  the checked-in ``libimgops.so``) on the same inputs: the integer paths
  (nearest resize, flips, LUT, nearest warp) equal; the float paths within
  1 on all elements and unequal on at most 1% of them (measured here at
  37x53 and 512x512: at most 0.31%, CLAHE at 37x53).  The reason, measured:
  the JAX source compiled here with the port's flags gives the port's
  outputs bit for bit (``test_same_functions_as_the_jax_source``), so the
  two sources compute the same functions and the checked-in library
  rounds some float sums otherwise (``-march=native`` on another host).
- The port's generator batches with both native paths on against JAX's.
- The build: a hash-named file that six concurrent builds leave whole; a
  build that fails warns once with the compiler's message and leaves the
  numpy path; ``augment`` sends uint8 images only through the library.
"""

import ctypes
import os
import random
import threading
import warnings

import numpy as np
import pytest

import deeplab_tpu.data.native as JN
from deeplab_tpu.data import generator as JG

from deeplab_tpu_torch.data import augment as TA
from deeplab_tpu_torch.data import generator as TG
from deeplab_tpu_torch.data import native as TN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC = os.path.join(REPO, "tests", "data", "mini_voc")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert TN.available(), TN.BUILD_LOG


@pytest.fixture(scope="module")
def img():
    return np.random.RandomState(0).randint(0, 256, (37, 53, 3), np.uint8)


@pytest.fixture(scope="module")
def gray():
    return np.random.RandomState(1).randint(0, 256, (37, 53), np.uint8)


def _numpy_path(fn, *args, **kw):
    with TN.masked():
        assert not TN.available()
        return fn(*args, **kw)


def _share_over(a, b, atol=1):
    return np.mean(np.abs(a.astype(int) - b.astype(int)) > atol)


# --------------------------------------- against the port's numpy path ----

def test_resize_bilinear_parity(img):
    got = TN.resize_bilinear(img, (64, 48))
    assert _share_over(got, _numpy_path(TA.resize_bilinear, img,
                                        (64, 48))) < 0.01


def test_resize_nearest_parity(gray):
    np.testing.assert_array_equal(
        TN.resize_nearest(gray, (64, 48)),
        _numpy_path(TA.resize_nearest, gray, (64, 48)))


def test_flip_parity(img):
    np.testing.assert_array_equal(TN.flip(img, 1), img[:, ::-1])
    np.testing.assert_array_equal(TN.flip(img, 0), img[::-1])


def test_lut_parity(img):
    table = TA.gamma_lut(1.4)
    np.testing.assert_array_equal(TN.apply_lut(img, table), table[img])


def test_warp_affine_parity(img, gray):
    M = TA.rotation_matrix((26, 18), 7.0, 1.1)
    got = TN.warp_affine(img, M, (53, 37))
    assert _share_over(got, _numpy_path(TA.warp_affine, img, M,
                                        (53, 37))) < 0.01
    got_n = TN.warp_affine(gray, M, (53, 37), nearest=True)
    ref_n = _numpy_path(TA.warp_affine, gray, M, (53, 37), nearest=True)
    assert np.mean(got_n != ref_n) < 0.01


def test_gaussian_blur_parity(img):
    assert _share_over(TN.gaussian_blur(img, 5),
                       _numpy_path(TA.gaussian_blur, img, 5)) < 0.01


def test_color_conversion_parity(img):
    got = TN.bgr_to_yuv(img)
    assert _share_over(got, _numpy_path(TA.bgr_to_yuv, img)) < 0.01
    assert _share_over(TN.yuv_to_bgr(got),
                       _numpy_path(TA.yuv_to_bgr, got)) < 0.01


def test_clahe_parity():
    ch = np.random.RandomState(3).randint(0, 256, (64, 64), np.uint8)
    assert _share_over(TN.clahe(ch, 2.0, (8, 8)),
                       _numpy_path(TA.clahe, ch, 2.0, (8, 8))) < 0.02


# ------------------------------------------ against the JAX library ----

def _ops(img, gray):
    H, W = img.shape[:2]
    M = TA.rotation_matrix((W / 2, H / 2), 7.0, 1.1)
    return {
        "resize_bilinear": (False, lambda N: N.resize_bilinear(img, (64, 48))),
        "resize_nearest": (True, lambda N: N.resize_nearest(gray, (64, 48))),
        "flip": (True, lambda N: np.stack([N.flip(img, 0), N.flip(img, 1)])),
        "apply_lut": (True, lambda N: N.apply_lut(img, TA.gamma_lut(1.4))),
        "warp_affine": (False, lambda N: N.warp_affine(img, M, (W, H))),
        "warp_nearest": (True, lambda N: N.warp_affine(gray, M, (W, H),
                                                       True)),
        "gaussian_blur": (False, lambda N: np.stack([N.gaussian_blur(img, 5),
                                                     N.gaussian_blur(img,
                                                                     9)])),
        "bgr_to_yuv": (False, lambda N: N.bgr_to_yuv(img)),
        "yuv_to_bgr": (False, lambda N: N.yuv_to_bgr(img)),
        "clahe": (False, lambda N: N.clahe(gray, 2.0, (8, 8))),
    }


OPS = list(_ops(np.zeros((2, 2, 3), np.uint8), np.zeros((2, 2), np.uint8)))


@pytest.mark.skipif(not JN.available(),
                    reason="the JAX package's native library is not built")
@pytest.mark.parametrize("shape", [(37, 53), (512, 512)])
@pytest.mark.parametrize("op", OPS)
def test_op_against_jax_library(op, shape):
    r = np.random.RandomState(4)
    img = r.randint(0, 256, shape + (3,), np.uint8)
    exact, fn = _ops(img, img[..., 1].copy())[op]
    got, want = fn(TN), fn(JN)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, diff.max()
        assert np.mean(diff > 0) <= 0.01, np.mean(diff > 0)


def test_same_functions_as_the_jax_source(tmp_path):
    """The JAX package's source compiled with the port's flags gives the
    port's library's outputs bit for bit, at every op."""
    src = os.path.join(REPO, "native", "imgops.cpp")
    out = tmp_path / "libjax.so"
    cxx = TN._cxx()
    assert cxx is not None
    import subprocess
    subprocess.run([cxx, *TN.CXX_FLAGS, "-o", str(out), src], check=True,
                   capture_output=True)
    other = TN._bind(ctypes.CDLL(str(out)))
    r = np.random.RandomState(5)
    img = r.randint(0, 256, (96, 80, 3), np.uint8)
    ops = _ops(img, img[..., 2].copy())
    mine = {k: fn(TN) for k, (_, fn) in ops.items()}
    saved = TN._LIB
    TN._LIB = other
    try:
        theirs = {k: fn(TN) for k, (_, fn) in ops.items()}
    finally:
        TN._LIB = saved
    for k in ops:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


@pytest.mark.skipif(not JN.available(),
                    reason="the JAX package's native library is not built")
def test_generator_batches_with_both_native_paths_against_jax():
    """Train-mode batches, every augmentation on, against JAX's with its
    own library: image values within 2 on >= 99% of entries and labels
    equal on >= 97% of pixels, tests/test_torch_data_path.py's tolerances
    for the same comparison (measured: 0.9988 and 1.0 on the first batch,
    1.0 and 1.0 on the others)."""
    aug = dict(blur=5, horizontal_flip=True, vertical_flip=True,
               brightness=0.3, rotation=10.0, zoom=0.1, do_ahisteq=True)
    args = dict(folder=VOC, mode="train", n_classes=21, batch_size=4,
                validation_split=0.2, seed=7, crop_shape=(72, 64), **aug)
    gens = TG.SegmentationGenerator(**args), JG.SegmentationGenerator(**args)
    out = []
    for gen in gens:
        batches = []
        for i, s in enumerate((31, 32, 33)):
            random.seed(s)
            np.random.seed(s)
            X, Y, sw = gen[i]
            batches.append((X.copy(), Y.copy()))
        out.append(batches)
    shares = [(float((np.abs(tx - jx) <= 2).mean()),
               float((ty == jy).mean()))
              for (tx, ty), (jx, jy) in zip(*out)]
    print("both native paths: (X share within 2, Y share equal) per batch:",
          shares)
    assert all(x >= 0.99 and y >= 0.97 for x, y in shares), shares


# ------------------------------------------------------------ the build ----

@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A native module with nothing built or loaded, building into
    ``tmp_path``."""
    monkeypatch.setattr(TN, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(TN, "_LIB", None)
    monkeypatch.setattr(TN, "_TRIED", False)
    return tmp_path


def test_concurrent_builds_leave_one_whole_library(fresh):
    paths, errors = [], []

    def one():
        try:
            paths.append(TN.build())
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=one) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(paths)) == 1 and paths[0] == TN.lib_path()
    assert os.path.dirname(paths[0]) == str(fresh)
    assert sorted(os.listdir(fresh)) == [os.path.basename(paths[0])]
    lib = TN._bind(ctypes.CDLL(paths[0]))
    assert lib.resize_bilinear_u8 is not None


def test_a_failed_build_warns_once_and_keeps_numpy(fresh, monkeypatch,
                                                   img):
    monkeypatch.setattr(TN, "CXX_FLAGS", TN.CXX_FLAGS + ["-no-such-flag"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not TN.available()
        assert not TN.available()
        got = TA.resize_bilinear(img, (64, 48))
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "no-such-flag" in msgs[0], msgs
    with TN.masked():
        want = TA.resize_bilinear(img, (64, 48))
    np.testing.assert_array_equal(got, want)


def test_augment_routes_only_uint8_through_the_library(monkeypatch, img):
    calls = []
    real = TN.resize_bilinear
    monkeypatch.setattr(TN, "resize_bilinear",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    TA.resize_bilinear(img, (64, 48))
    TA.resize_bilinear(img.astype(np.float32), (64, 48))
    TA.resize_bilinear(img, (53, 37))      # same size: a copy, no call
    assert calls == [np.uint8]
