"""The port's Predictor with the production CRF against the JAX Predictor on
the CPU: the four ``tests/data/mini_voc`` tiles at 128x128 with the
``mini_voc_trained.h5`` weights, float32 on both sides, the JAX CRF forced
to its plane engine (``backend="pallas"``, interpret mode).

Masks must agree on >= 0.99 of the pixels (measured 1.0: the f32 logits
differ only by summation order, and the CRF's plain versions follow the
Pallas kernels' rounding points).
"""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from deeplab_tpu import crf as JCRF
from deeplab_tpu.data.generator import _imread_bgr
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload
from deeplab_tpu.predictor import Predictor as JPredictor

from deeplab_tpu_torch import crf as TCRF
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
def jax_out(tiles):
    net = JSegNet((SZ, SZ), 3, "mobilenetv2", "original")
    params, state = jload(H5, *net.init(jax.random.key(0)))
    cfg = dataclasses.replace(JCRF.PRODUCTION_CONFIG, backend="pallas")
    return JPredictor(net, params, state, crf=cfg, compute_dtype=jnp.float32,
                      return_raw=True)(tiles)


@pytest.fixture(scope="module")
def port():
    return Predictor(load_keras_h5(H5, SegNet((SZ, SZ), 3)),
                     crf=TCRF.PRODUCTION_CONFIG, compute_dtype="float32",
                     device="cpu", return_raw=True)


def test_crf_masks_match_jax(tiles, jax_out, port):
    raw, refined = port(tiles)
    assert refined.shape == (4, SZ, SZ) and refined.dtype == np.int32
    j_raw, j_ref = jax_out
    assert (j_ref != j_raw).mean() > 0     # the CRF moved some pixels
    agree = float((refined == j_ref).mean())
    print(f"CRF mask agreement with JAX: {agree:.5f}; raw "
          f"{float((raw == j_raw).mean()):.5f}")
    assert agree >= 0.99, agree


def test_return_raw_is_the_crf_free_output(tiles, port):
    raw, refined = port(tiles)
    plain = Predictor(port.net, compute_dtype="float32", device="cpu")
    np.testing.assert_array_equal(raw, plain(tiles))
    only = Predictor(port.net, crf=TCRF.PRODUCTION_CONFIG,
                     compute_dtype="float32", device="cpu")(tiles)
    np.testing.assert_array_equal(only, refined)
