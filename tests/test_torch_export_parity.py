"""The serving artifact (deeplab_tpu_torch/export.py) on the CPU, beside
the JAX package: the trained mini_voc tiles at 128x128 (float32,
``PRODUCTION_CONFIG``) against the JAX ``Predictor``, the weight keys and
arrays against the JAX ``export._flat_keys``; a fixed batch that pads and
raises; the XLA engine at a fixed batch.  Each artifact runs from the
``ExportedProgram`` that ``save_serving`` returned, with its saved file's
arrays and meta (``tests/test_torch_export.py`` loads one back).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from deeplab_tpu import crf as JCRF
from deeplab_tpu.data.generator import _imread_bgr
from deeplab_tpu.export import _flat_keys as jax_flat_keys
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload
from deeplab_tpu.predictor import Predictor as JPredictor

from deeplab_tpu_torch import crf as TCRF
from deeplab_tpu_torch import export as E
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_keras_h5
from deeplab_tpu_torch.predictor import Predictor

DATA = os.path.join(os.path.dirname(__file__), "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
PROD = TCRF.PRODUCTION_CONFIG
SZ = 32


def _images(b, seed=0, sz=SZ):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, sz, sz, 3) * 255).astype(np.float32)


def _saved(path, net, **kw):
    """save_serving, then the artifact run from the ExportedProgram it
    returned with the file's arrays and meta (no deserialization)."""
    ep = E.save_serving(path, net, device="cpu", **kw)
    with np.load(path) as npz:
        meta = json.loads(bytes(npz[E._META_KEY].tobytes()).decode())
        arrays = {k: npz[k] for k in npz.files if not k.startswith("__")}
    return ep, E.ServingArtifact(ep, arrays, meta)



@pytest.fixture(scope="module")
def fixed(tmp_path_factory):
    """A fixed batch of 4 without the CRF, float32."""
    net = SegNet((SZ, SZ), 5, seed=2)
    path = str(tmp_path_factory.mktemp("export") / "fixed.npz")
    _, art = _saved(path, net, batch=4, compute_dtype="float32")
    return art, Predictor(net, compute_dtype="float32", device="cpu")


def test_fixed_batch_pads_and_raises(fixed):
    art, live = fixed
    assert art.batch == 4 and E.op_counts(art.program) == {}
    for b in (4, 3, 1):
        x = _images(b, seed=10 + b)
        np.testing.assert_array_equal(art(x), live(x))
    with pytest.raises(ValueError, match="exceeds"):
        art(_images(5))


def test_xla_engine_fixed_batch_equals_live(tmp_path):
    cfg = TCRF.CrfConfig(backend="xla", n_iters=2)
    net = SegNet((SZ, SZ), 4, seed=3)
    ep, art = _saved(str(tmp_path / "xla.npz"), net, crf=cfg, batch=2,
                     compute_dtype="float32")
    counts = E.op_counts(ep)
    # per image one filter for the norm, one per iteration
    assert counts["splat_planes"] == counts["slice_planes"] == 2 * 3
    x = _images(2, seed=6)
    np.testing.assert_array_equal(
        art(x), Predictor(net, crf=cfg, compute_dtype="float32",
                          device="cpu")(x))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The mini_voc tiles at 128x128 with the trained weights, float32
    with PRODUCTION_CONFIG."""
    d = os.path.join(DATA, "mini_voc", "JPEGImages", "train")
    tiles = np.stack([_imread_bgr(os.path.join(d, f))
                      for f in sorted(os.listdir(d))[:2]]).astype(np.float32)
    net = load_keras_h5(H5, SegNet((128, 128), 3))
    path = str(tmp_path_factory.mktemp("export") / "trained.npz")
    _, art = _saved(path, net, crf=PROD, compute_dtype="float32")
    return tiles, net, path, art


def test_trained_artifact_agrees_with_jax_predictor(trained):
    tiles, net, _, art = trained
    jnet = JSegNet((128, 128), 3, "mobilenetv2", "original")
    params, state = jload(H5, *jnet.init(jax.random.key(0)))
    cfg = dataclasses.replace(JCRF.PRODUCTION_CONFIG, backend="pallas")
    want = np.asarray(JPredictor(jnet, params, state, crf=cfg,
                                 compute_dtype=jnp.float32)(tiles))
    got = art(tiles)
    agree = float((got == want).mean())
    print(f"artifact against the JAX Predictor: {agree:.5f}")
    assert agree >= 0.99, agree
    np.testing.assert_array_equal(
        got, Predictor(net, crf=PROD, compute_dtype="float32",
                       device="cpu")(tiles))


def test_weight_keys_and_arrays_equal_jax_flat_keys(trained):
    _, _, path, _ = trained
    jnet = JSegNet((128, 128), 3, "mobilenetv2", "original")
    params, state = jload(H5, *jnet.init(jax.random.key(0)))
    want = dict(jax_flat_keys(params, "p"))
    want.update(jax_flat_keys(state, "s"))
    with np.load(path) as npz:
        got = {k: npz[k] for k in npz.files if not k.startswith("__")}
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
