"""Weight files of the port (deeplab_tpu_torch/params.py) against the JAX
package's, on the CPU: the numpy-only ``.npz`` (``save_npz``/``load_npz``,
the serving artifact's keys in the Keras layouts), the Keras-2 h5 writer,
and the Keras-3 ``.weights.h5`` layout.

``tests/data/mini_voc_trained.npz`` is ``tests/data/mini_voc_trained.h5``
converted by ``tools/h5_to_npz.py``: it must load the same arrays as the h5
into the port's net and, through the JAX artifact's key scheme, into the JAX
package's trees, with no ``h5py``.  Weights are moved, not computed, so every
comparison is exact.
"""

import os
import sys

import h5py
import numpy as np
import pytest
import jax
import torch

from deeplab_tpu.export import _flat_keys as jax_flat_keys
from deeplab_tpu.export import _unflatten as jax_unflatten
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload_h5
from deeplab_tpu.params import save_keras_h5 as jsave_h5

from deeplab_tpu_torch import params as P
from deeplab_tpu_torch.models.seg_model import SegNet

DATA = os.path.join(os.path.dirname(__file__), "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
NPZ = os.path.join(DATA, "mini_voc_trained.npz")


def _assert_nets_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for layer in want:
        assert got[layer].keys() == want[layer].keys(), layer
        for var in want[layer]:
            np.testing.assert_array_equal(np.asarray(got[layer][var]),
                                          np.asarray(want[layer][var]),
                                          err_msg=f"{layer}/{var}")


def _scramble(net, seed):
    """Seeded values in every parameter and buffer, so that a load that
    skips a tensor shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(net.parameters()) + list(net.buffers()):
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return net


@pytest.mark.parametrize("backbone,head", [("mobilenetv2", "original"),
                                           ("mobilenetv2", "subpixel")])
def test_npz_round_trip(tmp_path, backbone, head):
    src = _scramble(SegNet((32, 32), 3, backbone, head, alpha=0.35), 1)
    path = str(tmp_path / "w.npz")
    P.save_npz(path, src)
    assert not os.path.exists(path + ".tmp")
    dst = P.load_npz(path, SegNet((32, 32), 3, backbone, head, alpha=0.35,
                                  seed=5))
    _assert_nets_equal(dst, src)
    # strict: a net with another layer set raises; by name it loads the
    # layers both have
    other = SegNet((32, 32), 3, backbone,
                   "subpixel" if head == "original" else "original",
                   alpha=0.35)
    with pytest.raises(KeyError):
        P.load_npz(path, other)
    P.load_npz(path, other, strict=False)
    assert torch.equal(other.Conv.kernel, src.Conv.kernel)
    # another width: the shapes disagree
    with pytest.raises(ValueError, match="shape mismatch"):
        P.load_npz(path, SegNet((32, 32), 3, backbone, head, alpha=0.5))


def test_mini_voc_npz_equals_h5_in_both_packages(monkeypatch):
    from_h5 = P.load_keras_h5(H5, SegNet((64, 64), 3, seed=1))
    jnet = JSegNet((64, 64), 3, "mobilenetv2", "original")
    jparams, jstate = jload_h5(H5, *jnet.init(jax.random.key(0)))
    want = dict(jax_flat_keys(jparams, "p"))
    want.update(jax_flat_keys(jstate, "s"))
    with np.load(NPZ, allow_pickle=False) as npz:
        got = {k: npz[k] for k in npz.files}
        # the JAX package's reader of its artifact's weights takes the file
        jtrees = jax_unflatten(npz)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    _assert_trees_equal(jtrees[0], jparams)
    _assert_trees_equal(jtrees[1], jstate)
    # the card has no h5py: the npz loads without it
    monkeypatch.setitem(sys.modules, "h5py", None)
    from_npz = P.load_npz(NPZ, SegNet((64, 64), 3, seed=2))
    _assert_nets_equal(from_npz, from_h5)
    _assert_nets_equal(P.load_weights(NPZ, SegNet((64, 64), 3, seed=3)),
                       from_h5)


def test_port_h5_is_read_by_jax_and_jax_h5_by_the_port(tmp_path):
    src = _scramble(SegNet((32, 32), 3, alpha=0.35), 2)
    path = str(tmp_path / "port.h5")
    P.save_keras_h5(path, src)
    jnet = JSegNet((32, 32), 3, "mobilenetv2", "original", alpha=0.35)
    jparams, jstate = jload_h5(path, *jnet.init(jax.random.key(0)),
                               strict=True)
    params, state = P.trees_from_net(src)
    _assert_trees_equal(jax.tree.map(np.asarray, jparams), params)
    _assert_trees_equal(jax.tree.map(np.asarray, jstate), state)

    jp, js = jnet.init(jax.random.key(3))
    jpath = str(tmp_path / "jax.h5")
    jsave_h5(jpath, jp, js)
    dst = P.load_keras_h5(jpath, SegNet((32, 32), 3, alpha=0.35, seed=4))
    params, state = P.trees_from_net(dst)
    _assert_trees_equal(params, jax.tree.map(np.asarray, jp))
    _assert_trees_equal(state, jax.tree.map(np.asarray, js))


def _write_keras3(path, params, state):
    """A Keras-3 ``.weights.h5`` by hand: ``layers/<layer>/vars/<i>``, the
    layer's name an attribute of ``vars``, the arrays in Keras-3 save order
    (conv: kernel, bias; depthwise: depthwise_kernel; BN: gamma, beta,
    moving_mean, moving_variance)."""
    order = ("kernel", "depthwise_kernel", "bias", "gamma", "beta",
             "moving_mean", "moving_variance")
    with h5py.File(path, "w") as f:
        layers = f.create_group("layers")
        for layer in sorted(set(params) | set(state)):
            merged = {**params.get(layer, {}), **state.get(layer, {})}
            g = layers.create_group(layer.lower()).create_group("vars")
            g.attrs["name"] = layer
            for i, var in enumerate(v for v in order if v in merged):
                g.create_dataset(str(i), data=np.asarray(merged[var]))


def test_keras3_layout_loads_equal_arrays_in_both_packages(tmp_path):
    jnet = JSegNet((32, 32), 3, "mobilenetv2", "subpixel", alpha=0.35)
    jp, js = jax.tree.map(np.asarray, jnet.init(jax.random.key(5)))
    path = str(tmp_path / "k3.weights.h5")
    _write_keras3(path, jp, js)
    jparams, jstate = jload_h5(path, *jnet.init(jax.random.key(0)))
    _assert_trees_equal(jax.tree.map(np.asarray, jparams), jp)
    _assert_trees_equal(jax.tree.map(np.asarray, jstate), js)
    net = P.load_keras_h5(path, SegNet((32, 32), 3, "mobilenetv2",
                                       "subpixel", alpha=0.35, seed=6))
    params, state = P.trees_from_net(net)
    _assert_trees_equal(params, jp)
    _assert_trees_equal(state, js)


def test_weights_suffix_follows_h5py(monkeypatch):
    assert P.weights_suffix() == ".h5"
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert not P.h5_available() and P.weights_suffix() == ".npz"
