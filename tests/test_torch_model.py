"""The port's SegNet against the JAX SegNet on the CPU.

Weights: ``tests/data/mini_voc_trained.h5`` (a trained full-width MobileNetV2
with the 'original' head and 3 classes).  Images: ``tests/data/mini_voc``
tiles, 128x128 BGR, subsampled 2x to 64x64.

Tolerances: f32 logits through the ~60 layers differ only by summation order
in f32 (measured max 5.2e-6 on logits up to 6.3), held at 1e-4 absolute.  Under "mixed" the port rounds every conv operand to bf16 as the TPU's
single MXU pass does, while JAX on the CPU computes "mixed" in full f32, so
the two only agree on the argmax; its agreement is reported and held to a
floor of 0.99 (measured: 0.9971 on these tiles).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu.data.generator import _imread_bgr
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload

from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_keras_h5, params_from_jax

DATA = os.path.join(os.path.dirname(__file__), "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
SZ = 64
MIXED_FLOOR = 0.99


def _tiles(n):
    d = os.path.join(DATA, "mini_voc", "JPEGImages", "train")
    names = sorted(os.listdir(d))[:n]
    return np.stack([_imread_bgr(os.path.join(d, f))[::2, ::2]
                     for f in names]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    net = JSegNet((SZ, SZ), 3, "mobilenetv2", "original")
    params, state = net.init(jax.random.key(0))
    params, state = jload(H5, params, state)
    return net, params, state


@pytest.fixture(scope="module")
def images():
    return _tiles(4)


@pytest.fixture(scope="module")
def jax_logits(jax_model, images):
    net, params, state = jax_model
    fn = jax.jit(lambda p, s, x: net.apply_logits(p, s, x)[0])
    return np.asarray(fn(params, state, jnp.asarray(images)))


def test_h5_load_equals_jax_load_through_params_from_jax(jax_model):
    _, params, state = jax_model
    a = load_keras_h5(H5, SegNet((SZ, SZ), 3, seed=1))
    b = params_from_jax(SegNet((SZ, SZ), 3, seed=2),
                        jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, state))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and len(sa) == 272
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)
    # the layouts really were converted: Conv is OIHW = HWIO permuted
    np.testing.assert_array_equal(
        sa["Conv.kernel"].numpy(),
        np.asarray(params["Conv"]["kernel"]).transpose(3, 2, 0, 1))


def test_full_width_f32_logits_match_jax(jax_logits, images):
    net = load_keras_h5(H5, SegNet((SZ, SZ), 3)).eval()
    got = net.logits(torch.from_numpy(images), "float32").numpy()
    assert got.shape == jax_logits.shape == (4, SZ, SZ, 3)
    assert np.abs(jax_logits).max() > 1.0   # trained weights: real logits
    np.testing.assert_allclose(got, jax_logits, rtol=1e-5, atol=1e-4)


def test_mixed_argmax_agreement_with_jax(jax_logits, images):
    net = load_keras_h5(H5, SegNet((SZ, SZ), 3)).eval()
    got = net.predict_ids(torch.from_numpy(images), "mixed").numpy()
    agree = float((got == jax_logits.argmax(-1)).mean())
    print(f"mixed argmax agreement with JAX: {agree:.4f}")
    assert agree >= MIXED_FLOOR, agree


def test_fused_gate_engages_under_mixed_and_bf16_only():
    """14 of the 17 blocks (ids 2, 4-16) take the fused path under "mixed"
    and bf16; float32 and unfused nets keep the composition."""
    from deeplab_tpu_torch import core
    from deeplab_tpu_torch.models import mobilenetv2 as M
    net = SegNet((SZ, SZ), 3).eval()
    x = torch.zeros(1, 8, 16, 16)
    count = lambda pol, n: sum(
        M._use_fused_block(n, x, core.resolve_compute_dtype(pol), s, b)
        for _, s, _, b, _, _ in M.BLOCK_TABLE)
    assert count("mixed", net) == count("bfloat16", net) == 14
    assert count("float32", net) == 0
    assert count("mixed", SegNet((SZ, SZ), 3, fuse_blocks=False).eval()) == 0
