"""The serving artifact (deeplab_tpu_torch/export.py) on the CPU, at the
production pipeline (MobileNetV2 "mixed" with ``PRODUCTION_CONFIG``,
64x64, a symbolic batch): the traced program carries every kernel as a
``deeplab_tpu_torch::`` operator, one node per eager call; it gives the
live ``Predictor``'s masks bit for bit at B = 1, 3, 5, records the JAX meta
fields, swaps weights without a re-export, and loads in a fresh
interpreter without the model code.  One ``torch.export`` trace and one
``torch.export.load`` for the file (seconds each here).  The JAX parity,
the weight keys, the fixed batch and the XLA engine are in
``tests/test_torch_export_parity.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from deeplab_tpu_torch import crf as TCRF
from deeplab_tpu_torch import export as E
from deeplab_tpu_torch.kernels import crf_fused as CK
from deeplab_tpu_torch.kernels import fused_dw as FDW
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.models import mobilenetv2 as MV2
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import trees_from_net
from deeplab_tpu_torch.predictor import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SZ = 64
PROD = TCRF.PRODUCTION_CONFIG
# the graph's operator for each kernel wrapper the eager run records
EAGER_NAMES = {"fused_mbconv": "fused_mbconv",
               "fused_dw_bn_relu6": "fused_dw_bn_relu6",
               "splat_planes": "splat_planes",
               "slice_attrs_planes": "slice_attrs_planes",
               "gaussian_blur_planes": "blur_rows",
               "mf_step_planes": "mf_step_planes"}


def _images(b, seed=0, sz=SZ):
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, sz, sz, 3) * 255).astype(np.float32)
    x[:, sz // 4:sz // 2, sz // 3:] = (30, 200, 90)    # a flat region
    return x


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The production pipeline at 64x64: MobileNetV2 "mixed" with
    PRODUCTION_CONFIG, symbolic batch, saved and loaded back."""
    path = str(tmp_path_factory.mktemp("export") / "prod.npz")
    net = SegNet((SZ, SZ), 21)
    ep = E.save_serving(path, net, crf=PROD, device="cpu")
    live = Predictor(net, crf=PROD, compute_dtype="mixed", device="cpu")
    return path, ep, E.load_serving(path), live


def test_graph_carries_each_kernel_launch(mixed, monkeypatch):
    """One node per launch: the eager CPU run's calls of each kernel
    wrapper (the CRF's under plain_versions, the fused blocks' at their
    gates) equal the program's operator counts."""
    _, ep, art, live = mixed
    calls = {"fused_mbconv": 0, "fused_dw_bn_relu6": 0}

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(FM, "fused_mbconv",
                        counting("fused_mbconv", FM.fused_mbconv))
    monkeypatch.setattr(MV2.FDW, "fused_dw_bn_relu6",
                        counting("fused_dw_bn_relu6",
                                 FDW.fused_dw_bn_relu6))
    with CK.plain_versions() as rec:
        live(_images(1))
    calls.update({n: len(v) for n, v in rec.items()})
    want = {EAGER_NAMES[n]: k for n, k in calls.items() if k}
    assert want == {"fused_mbconv": 14, "fused_dw_bn_relu6": 1,
                    "splat_planes": 6, "slice_attrs_planes": 1,
                    "blur_rows": 5, "mf_step_planes": 5}
    assert E.op_counts(ep) == want
    assert E.op_counts(art.program) == want == art.meta["ops"]


@pytest.mark.parametrize("b", [1, 3, 5])
def test_symbolic_batch_equals_live_predictor(mixed, b):
    _, _, art, live = mixed
    x = _images(b, seed=b)
    out = art(x)
    assert out.shape == (b, SZ, SZ) and out.dtype == np.int32
    np.testing.assert_array_equal(out, live(x))


def test_meta_records_the_jax_fields(mixed):
    _, _, art, _ = mixed
    m = art.meta
    assert m["version"] == E.ARTIFACT_VERSION
    assert m["image_size"] == [SZ, SZ] and m["n_classes"] == 21
    assert m["batch"] is None and m["compute_dtype"] == "mixed"
    assert m["platforms"] == ["cpu"]
    assert m["crf"] == dataclasses.asdict(PROD)
    assert (m["backbone"], m["net"]) == ("mobilenetv2", "original")


def test_with_params_equals_predictor_on_those_weights(mixed):
    _, _, art, _ = mixed
    other = SegNet((SZ, SZ), 21, seed=5)
    params, state = trees_from_net(other)
    x = _images(1, seed=9)
    got = art.with_params(params, state)(x)
    want = Predictor(other, crf=PROD, compute_dtype="mixed",
                     device="cpu")(x)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, art(x))
    with pytest.raises(KeyError):
        art.with_params({}, state)


def test_loader_alone_in_a_fresh_interpreter(mixed, tmp_path):
    """load_serving(...)(images) imports neither the model, the CRF nor the
    Predictor (nor JAX)."""
    path, _, _, live = mixed
    x = _images(1, seed=4)
    xin, xout = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xin, x)
    code = (
        "import sys, numpy as np\n"
        "from deeplab_tpu_torch.export import load_serving\n"
        f"np.save({xout!r}, load_serving({path!r})(np.load({xin!r})))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'jax' or "
        "m.startswith(('deeplab_tpu_torch.models', 'deeplab_tpu_torch.crf',"
        " 'deeplab_tpu_torch.predictor', 'deeplab_tpu.'))))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout
    np.testing.assert_array_equal(np.load(xout), live(x))


def test_two_devices_raise():
    with pytest.raises(ValueError, match="one device"):
        E.export_serving(SegNet((16, 16), 3), device=["cpu", "cuda"])


def test_xla_engine_needs_a_fixed_batch():
    with pytest.raises(ValueError, match="fixed batch"):
        E.export_serving(SegNet((16, 16), 3),
                         crf=TCRF.CrfConfig(backend="xla"), device="cpu")
