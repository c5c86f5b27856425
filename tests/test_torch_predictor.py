"""The port's Predictor against the JAX Predictor (crf=None) on the CPU, on
``tests/data/mini_voc`` tiles at their own 128x128 size, with the
``mini_voc_trained.h5`` weights.

float32 masks must agree on all but tie-breaking pixels (floor 0.999; the
f32 logits differ only by summation order).  The port's default "mixed"
policy rounds conv operands to bf16 where JAX on the CPU stays f32, so its
masks are held to the argmax floor of tests/test_torch_model.py (0.99).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from deeplab_tpu.data.generator import _imread_bgr
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload
from deeplab_tpu.predictor import Predictor as JPredictor

from deeplab_tpu_torch.crf import CrfConfig
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_keras_h5
from deeplab_tpu_torch.predictor import Predictor

DATA = os.path.join(os.path.dirname(__file__), "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
SZ = 128


@pytest.fixture(scope="module")
def tiles():
    d = os.path.join(DATA, "mini_voc", "JPEGImages", "train")
    names = sorted(os.listdir(d))[:4]
    return np.stack([_imread_bgr(os.path.join(d, f)) for f in names])


@pytest.fixture(scope="module")
def jax_masks(tiles):
    net = JSegNet((SZ, SZ), 3, "mobilenetv2", "original")
    params, state = jload(H5, *net.init(jax.random.key(0)))
    return JPredictor(net, params, state, crf=None,
                      compute_dtype=jnp.float32)(tiles)


@pytest.mark.parametrize("policy,floor", [("float32", 0.999), ("mixed", 0.99)])
def test_predictor_masks_match_jax(tiles, jax_masks, policy, floor):
    pred = Predictor(load_keras_h5(H5, SegNet((SZ, SZ), 3)),
                     compute_dtype=policy, device="cpu")
    got = pred(tiles)
    assert got.shape == (4, SZ, SZ) and got.dtype == np.int32
    assert len(np.unique(jax_masks)) > 1          # a real segmentation
    agree = float((got == jax_masks).mean())
    print(f"{policy} mask agreement with JAX: {agree:.5f}")
    assert agree >= floor, agree


@pytest.mark.parametrize("kw", [
    dict(mesh=object()), dict(spatial=True), dict(tta_scales=(0.5, 1.0)),
    dict(tta_flip=True),
    dict(crf=CrfConfig(resolution_scale=2)),
    dict(crf=CrfConfig(backend="xla")),
    # small-sigma cells need the spatial blur's image-layout fallback
    dict(crf=CrfConfig(sxy_bilateral=16.0))])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError):
        Predictor(SegNet((16, 16), 3), device="cpu", **kw)
