"""The port's Predictor against the JAX Predictor (crf=None) on the CPU, on
``tests/data/mini_voc`` tiles at their own 128x128 size, with the
``mini_voc_trained.h5`` weights.

float32 masks must agree on all but tie-breaking pixels (floor 0.999; the
f32 logits differ only by summation order).  The port's default "mixed"
policy rounds conv operands to bf16 where JAX on the CPU stays f32, so its
masks are held to the argmax floor of tests/test_torch_model.py (0.99).
"""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from deeplab_tpu.crf import CrfConfig as JCrfConfig
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
    dict(mesh=object()), dict(spatial=True),
    dict(tta_scales=(0.5, 1.0), spatial=True),
    dict(tta_flip=True, spatial=True)])
def test_later_slices_raise(kw, tiles):
    """A mesh must be a ``parallel.mesh.Mesh`` (TypeError); test-time
    augmentation is served, but with spatial sharding it raises ValueError
    as in JAX.  ``spatial=True`` without a mesh is the plain path, as in
    JAX: its masks equal the plain Predictor's."""
    if kw == dict(spatial=True):
        net = load_keras_h5(H5, SegNet((SZ, SZ), 3))
        got = Predictor(net, device="cpu", compute_dtype="float32",
                        **kw)(tiles)
        want = Predictor(net, device="cpu", compute_dtype="float32")(tiles)
        np.testing.assert_array_equal(got, want)
        return
    err, match = ((ValueError, "TTA") if "tta_scales" in kw
                  or "tta_flip" in kw else (TypeError, "Mesh"))
    with pytest.raises(err, match=match):
        Predictor(SegNet((16, 16), 3), device="cpu", **kw)


@pytest.mark.parametrize("cfg", [
    CrfConfig(resolution_scale=2),
    CrfConfig(backend="xla", resolution_scale=2),
    # 16x16 cells: the plane engine's image-layout blur
    CrfConfig(sxy_bilateral=16.0)])
def test_predictor_crf_configs_match_jax(tiles, cfg):
    """The CRF configurations that take the paths past the production one,
    served on the tiles with the trained weights in float32, against the
    JAX Predictor with the same CRF (the port's plane engine against JAX
    backend="pallas").  At 128x128 the trained net finds 3 classes (at
    32x32 one, which leaves a CRF nothing to refine)."""
    jcfg = JCrfConfig(**dict(dataclasses.asdict(cfg), backend=(
        "xla" if cfg.backend == "xla" else "pallas")))
    jnet = JSegNet((SZ, SZ), 3, "mobilenetv2", "original")
    params, state = jload(H5, *jnet.init(jax.random.key(0)))
    raw, want = JPredictor(jnet, params, state, crf=jcfg,
                           compute_dtype=jnp.float32, return_raw=True)(tiles)
    pred = Predictor(load_keras_h5(H5, SegNet((SZ, SZ), 3)), crf=cfg,
                     compute_dtype="float32", device="cpu")
    got = pred(tiles)
    assert got.shape == (4, SZ, SZ) and got.dtype == np.int32
    changed = float((np.asarray(raw) != np.asarray(want)).mean())
    agree = float((got == np.asarray(want)).mean())
    print(f"{cfg}: mask agreement with JAX {agree:.5f} (its CRF changed "
          f"{changed:.4f} of the pixels)")
    assert changed > 0
    assert agree >= 0.99, agree


@pytest.mark.parametrize("cfg", [CrfConfig(backend="xla"),
                                 CrfConfig(sxy_bilateral=16.0,
                                           backend="xla")])
def test_xla_engine_takes_any_cell_geometry(cfg):
    """The XLA engine's square cells at the default sigma and at the
    notebook's CrfConfig(sxy_bilateral=16)."""
    pred = Predictor(SegNet((32, 32), 3), crf=cfg, device="cpu")
    out = pred(np.random.RandomState(0).rand(2, 32, 32, 3) * 255)
    assert out.shape == (2, 32, 32) and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < 3
