"""The data path behind ``cli evaluate`` against the JAX package's: the
reference split, the augmenting ``SegmentationGenerator`` (train mode, every
augmentation on, ``random`` and ``np.random`` seeded alike on both sides),
the numpy augmentations one by one, the class weights, the VOC catalogue and
the ``SegModel`` facade.

Both packages route uint8 images through their native libraries where
they are built.  With both native paths switched off the two generators
give the same batches exactly; with both on, the stated tolerances hold
(the two libraries compute the same functions from two builds with other
flags: JAX's with ``-march=native``, whose FMA contraction rounds some
float paths otherwise; tests/test_torch_native.py measures it op by op).
"""

import os
import random

import numpy as np
import pytest

import deeplab_tpu.data.native as JN
import deeplab_tpu_torch.data.native as TN
from deeplab_tpu.data import augment as JA
from deeplab_tpu.data import class_weights as JW
from deeplab_tpu.data import generator as JG
from deeplab_tpu.data import voc as JV
from deeplab_tpu.models.seg_model import SegModel as JSegModel

from deeplab_tpu_torch.data import augment as TA
from deeplab_tpu_torch.data import class_weights as TW
from deeplab_tpu_torch.data import generator as TG
from deeplab_tpu_torch.data import voc as TV
from deeplab_tpu_torch.models.seg_model import SegModel, SegNet

VOC = os.path.join(os.path.dirname(__file__), "data", "mini_voc")
# with both native paths on: image values (0-255) within 2 on >= 99% of
# entries, labels equal on >= 97% of pixels, weights where labels agree
NATIVE_X_ATOL, NATIVE_X_SHARE, NATIVE_Y_SHARE = 2.0, 0.99, 0.97
AUG = dict(blur=5, horizontal_flip=True, vertical_flip=True,
           brightness=0.3, rotation=10.0, zoom=0.1, do_ahisteq=True)


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(JN, "available", lambda: False)
    monkeypatch.setattr(TN, "available", lambda: False)


@pytest.mark.parametrize("n,split,seed,mode", [
    (20, 0.2, 7, "train"), (20, 0.2, 7, "validation"), (100, 0.15, 3,
                                                         "train"),
    (100, 0.05, 0, "validation"), (7, 0.5, 11, "train")])
def test_reference_split_equals_jax(n, split, seed, mode):
    np.testing.assert_array_equal(TG.reference_split(n, split, seed, mode),
                                  JG.reference_split(n, split, seed, mode))


def _batches(gen, seeds):
    out = []
    for i, s in enumerate(seeds):
        random.seed(s)
        np.random.seed(s)
        X, Y, sw = gen[i % len(gen)]
        out.append((X.copy(), Y.copy(), sw["pred_mask"].copy()))
    return out


def _pair(**kw):
    args = dict(folder=VOC, mode="train", n_classes=21, batch_size=4,
                validation_split=0.2, seed=7, **AUG)
    args.update(kw)
    return TG.SegmentationGenerator(**args), JG.SegmentationGenerator(**args)


@pytest.mark.parametrize("shape", [dict(resize_shape=(96, 80),
                                        crop_shape=None),
                                   dict(crop_shape=(72, 64))],
                         ids=["resize", "crop"])
def test_generator_batches_equal_jax_without_native(no_native, shape):
    tgen, jgen = _pair(**shape)
    assert len(tgen) == len(jgen) == 4
    assert tgen.image_path_list == jgen.image_path_list
    seeds = [11, 12, 13, 14, 15]
    for (tx, ty, tw), (jx, jy, jw) in zip(_batches(tgen, seeds),
                                          _batches(jgen, seeds)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tw, jw)


def test_generator_batches_near_jax_with_native():
    if not JN.available():
        pytest.skip("the JAX package's native library is not built here")
    assert TN.available(), TN.BUILD_LOG
    tgen, jgen = _pair(resize_shape=(96, 80), crop_shape=None)
    seeds = [21, 22, 23]
    shares = []
    for (tx, ty, tw), (jx, jy, jw) in zip(_batches(tgen, seeds),
                                          _batches(jgen, seeds)):
        close = float((np.abs(tx - jx) <= NATIVE_X_ATOL).mean())
        same = ty[..., 0] == jy[..., 0]
        shares.append((close, float(same.mean())))
        assert close >= NATIVE_X_SHARE, close
        assert same.mean() >= NATIVE_Y_SHARE, same.mean()
    print("native path: (X share within atol, Y share equal) per batch:",
          shares)


def test_validation_generator_is_unaugmented(no_native):
    tgen, jgen = _pair(mode="validation", resize_shape=(128, 128),
                       crop_shape=None, blur=0, brightness=0.0,
                       rotation=0.0, zoom=0.0, horizontal_flip=False,
                       vertical_flip=False, do_ahisteq=False)
    for (tx, ty, tw), (jx, jy, jw) in zip(_batches(tgen, [1]),
                                          _batches(jgen, [2])):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tw, jw)


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    img = (rng.rand(37, 53, 3) * 255).astype(np.uint8)
    img[10:25, 15:40] = (200, 40, 90)
    return img, rng.randint(0, 6, (37, 53)).astype(np.uint8)


M = JA.rotation_matrix((26, 18), 12.5, 1.1)
OPS = {
    "flip_horizontal": lambda A, im, lab: A.flip_horizontal(im),
    "flip_vertical": lambda A, im, lab: A.flip_vertical(lab),
    "gamma": lambda A, im, lab: A.apply_lut(im, A.gamma_lut(0.7)),
    "gamma_inv": lambda A, im, lab: A.apply_lut(im, A.gamma_lut(1 / 1.3)),
    "rotation_matrix": lambda A, im, lab: A.rotation_matrix((26, 18), 12.5,
                                                            1.1),
    "warp_bilinear": lambda A, im, lab: A.warp_affine(im, M, (53, 37)),
    "warp_label": lambda A, im, lab: A.warp_affine(lab, M, (53, 37)),
    "warp_nearest": lambda A, im, lab: A.warp_affine(im, M, (53, 37),
                                                     nearest=True),
    "warp_float": lambda A, im, lab: A.warp_affine(im.astype(np.float32), M,
                                                   (40, 30)),
    "blur3": lambda A, im, lab: A.gaussian_blur(im, 3),
    "blur5": lambda A, im, lab: A.gaussian_blur(im, 5),
    "blur9": lambda A, im, lab: A.gaussian_blur(im, 9),
    "kernel_1d": lambda A, im, lab: A.gaussian_kernel_1d(11, 2.0),
    "yuv": lambda A, im, lab: A.bgr_to_yuv(im),
    "yuv_back": lambda A, im, lab: A.yuv_to_bgr(A.bgr_to_yuv(im)),
    "clahe": lambda A, im, lab: A.clahe(im[..., 1]),
    "clahe_bgr": lambda A, im, lab: A.clahe_bgr(im),
    "resize_bilinear": lambda A, im, lab: A.resize_bilinear(im, (31, 45)),
    "resize_nearest": lambda A, im, lab: A.resize_nearest(lab, (70, 20)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_augment_op_equals_jax_numpy_path(no_native, images, name):
    im, lab = images
    np.testing.assert_array_equal(OPS[name](TA, im, lab),
                                  OPS[name](JA, im, lab))


@pytest.mark.parametrize("n_classes,void_share", [(21, 0.0), (5, 0.2),
                                                  (3, 1.0)])
def test_class_weights_equal_jax(n_classes, void_share):
    rng = np.random.RandomState(n_classes)
    y = rng.randint(0, n_classes, 4096)
    y[rng.rand(4096) < void_share] = n_classes
    np.testing.assert_array_equal(TW.adaptive_pixel_weights(y, n_classes),
                                  JW.adaptive_pixel_weights(y, n_classes))
    np.testing.assert_array_equal(TW.fg_bg_pixel_weights(y, n_classes),
                                  JW.fg_bg_pixel_weights(y, n_classes))
    u = np.unique(y)
    np.testing.assert_array_equal(TW.balanced_class_weights(y, u),
                                  JW.balanced_class_weights(y, u))


def test_voc_catalogue_equals_jax():
    assert TV.get_VOC2012_classes() == JV.get_VOC2012_classes()


def test_seg_model_facade(no_native):
    seg = SegModel(VOC, (64, 64))
    seg.set_batch_size(2)
    net = seg.create_seg_model("original", n=3, alpha=0.35)
    assert isinstance(net, SegNet) and net.sz == (64, 64)
    assert seg.modelpath == "weights/mobilenetv2_original.h5"
    gen = seg.create_generators(mode="validation", do_ahisteq=False,
                                n_classes=3, validation_split=0.2)
    jseg = JSegModel(VOC, (64, 64))
    jseg.set_batch_size(2)
    jgen = jseg.create_generators(mode="validation", do_ahisteq=False,
                                  n_classes=3, validation_split=0.2)
    assert gen.image_path_list == jgen.image_path_list
    assert gen.resize_shape == jgen.resize_shape == (64, 64)
    seg.modelpath = os.path.join(VOC, "no_such_weights.h5")
    with pytest.raises(FileNotFoundError):
        seg.load_weights()
