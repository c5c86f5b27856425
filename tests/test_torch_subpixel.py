"""The subpixel head of the port against the JAX package's, on the CPU:
the phase shift and its inverse, ICNR, and ``weights/mobilenetv2_subpixel.h5``
through both packages' loaders into ``SegNet(..., "mobilenetv2",
"subpixel")``.

The shipped h5 is written by Keras 3's legacy-h5 writer: its BNs are at
identity statistics, its Subpixel layer is named ``subpixel_1`` and its
depthwise kernels are stored as ``<layer>/kernel``.  The port's loader reads
those as the 17 depthwise kernels; the JAX package's loader (frozen, a
fault logged in ROADMAP Queue C) maps no such name onto
``depthwise_kernel`` and leaves them at their initial values.  The port's
net starts from the JAX net's initial trees (``params_from_jax``) and both
load the file on top: every other array must then be equal.  For the
logits the JAX tree gets the same 17 arrays from the file, and the f32
logits agree to summation order (1e-4 absolute, and 1e-4 of the largest
logit).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu.data.generator import _imread_bgr
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.ops import init as jinit
from deeplab_tpu.ops import pixel_shuffle as jps
from deeplab_tpu.params import load_keras_h5 as jload

from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.ops import init as inits
from deeplab_tpu_torch.ops import pixel_shuffle as ps
from deeplab_tpu_torch.params import (load_keras_h5, params_from_jax,
                                      trees_from_net)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(REPO, "weights", "mobilenetv2_subpixel.h5")
TILES = os.path.join(REPO, "tests", "data", "mini_voc", "JPEGImages",
                     "train")
SZ, N_CLS = 64, 21


def _np_phase_shift(I, r):
    """numpy transcription of the reference's _phase_shift
    (subpixel.py:77-88), NHWC."""
    bsize, a, b, c = I.shape
    f = c // (r * r)
    X = I.reshape(bsize, a, b, f, r, r).transpose(0, 1, 2, 5, 4, 3)
    X = np.concatenate([X[:, i] for i in range(a)], axis=2)
    X = np.concatenate([X[:, j] for j in range(b)], axis=2)
    return X.reshape(bsize, a * r, b * r, f)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("r,f,h,w", [(8, 21, 2, 3), (4, 3, 5, 4), (2, 1, 3, 3)])
def test_phase_shift_matches_jax_and_reference(r, f, h, w):
    x = np.random.RandomState(r).randn(2, h, w, f * r * r).astype(np.float32)
    got = ps.phase_shift(_nchw(x), r).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jps.phase_shift(
        jnp.asarray(x), r)))
    np.testing.assert_array_equal(got, _np_phase_shift(x, r))
    back = ps.phase_shift_inverse(ps.phase_shift(_nchw(x), r), r)
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), x)


def test_phase_shift_is_not_pixel_shuffle():
    """nn.PixelShuffle reads channel f*r^2 + dr*r + dc, the reference
    f*r^2 + dc*r + dr: they differ wherever the r x r phases are not
    symmetric."""
    x = torch.arange(2 * 4 * 3 * 5, dtype=torch.float32).reshape(1, 8, 3, 5)
    ours = ps.phase_shift(x, 2)
    theirs = torch.nn.PixelShuffle(2)(x)
    assert ours.shape == theirs.shape == (1, 2, 6, 10)
    assert not torch.equal(ours, theirs)
    # the same with the two phase axes of the channels swapped
    swapped = x.reshape(1, 2, 2, 2, 3, 5).transpose(2, 3).reshape(1, 8, 3, 5)
    assert torch.equal(ours, torch.nn.PixelShuffle(2)(swapped))


@pytest.mark.parametrize("r", [4, 8])
def test_icnr_replicates_sub_kernels(r):
    k = inits.icnr(torch.Generator().manual_seed(0), (1, 1, 16, 3 * r * r), r)
    groups = k.reshape(1, 1, 16, 3, r * r)
    for i in range(1, r * r):
        torch.testing.assert_close(groups[..., i], groups[..., 0], rtol=0,
                                   atol=0)
    # the same layout as the JAX package's ICNR
    jk = np.asarray(jinit.icnr(jax.random.key(0), (1, 1, 16, 3 * r * r), r))
    np.testing.assert_array_equal(jk.reshape(1, 1, 16, 3, r * r)[..., 1],
                                  jk.reshape(1, 1, 16, 3, r * r)[..., 0])
    # the phase-shifted output of a constant image is constant per filter
    net = SegNet((16, 16), 3, "mobilenetv2", "subpixel", alpha=0.35)
    x = torch.ones(1, net.subpixel.kernel.shape[1], 1, 1)
    out = ps.phase_shift(torch.nn.functional.conv2d(x, net.subpixel.kernel),
                         net.scale)
    torch.testing.assert_close(out, out[:, :, :1, :1].expand_as(out))


@pytest.fixture(scope="module")
def jax_loaded():
    if not os.path.exists(H5):
        pytest.skip("weights/mobilenetv2_subpixel.h5 is not present")
    net = JSegNet((SZ, SZ), N_CLS, "mobilenetv2", "subpixel")
    p0, s0 = net.init(jax.random.key(0))
    p, s = jload(H5, p0, s0)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return net, np_tree(p0), np_tree(s0), np_tree(p), np_tree(s)


def _h5_depthwise_kernels():
    """{layer: (3, 3, C, 1) array} of the file's depthwise kernels, stored
    as ``<layer>/<layer>/kernel``."""
    import h5py
    out = {}
    with h5py.File(H5, "r") as f:
        for layer in f:
            if layer.endswith("_depthwise"):
                out[layer] = np.asarray(f[f"{layer}/{layer}/kernel"])
    return out


@pytest.fixture(scope="module")
def port_loaded(jax_loaded):
    _, p0, s0, _, _ = jax_loaded
    net = params_from_jax(SegNet((SZ, SZ), N_CLS, "mobilenetv2", "subpixel"),
                          p0, s0)
    return load_keras_h5(H5, net).eval()


def test_h5_loads_into_both_packages_with_equal_arrays(jax_loaded,
                                                       port_loaded):
    _, p0, _, jp, js = jax_loaded
    tp, ts = trees_from_net(port_loaded)
    dw = _h5_depthwise_kernels()
    assert len(dw) == 17
    for want, got in ((jp, tp), (js, ts)):
        assert want.keys() == got.keys()
        for layer in want:
            for var in want[layer]:
                if var == "depthwise_kernel":
                    continue
                np.testing.assert_array_equal(got[layer][var],
                                              want[layer][var],
                                              err_msg=f"{layer}/{var}")
    for layer, k in dw.items():
        # the port reads the file's "<layer>/kernel" as the depthwise kernel
        np.testing.assert_array_equal(tp[layer]["depthwise_kernel"], k,
                                      err_msg=layer)
        assert not np.array_equal(k, p0[layer]["depthwise_kernel"]), layer
        # the JAX loader leaves it at its initial value (ROADMAP Queue C)
        np.testing.assert_array_equal(jp[layer]["depthwise_kernel"],
                                      p0[layer]["depthwise_kernel"],
                                      err_msg=layer)
    # the auto-named subpixel_1 landed on the subpixel layer
    assert tp["subpixel"]["kernel"].shape == (1, 1, 256, N_CLS * 64)
    assert not np.array_equal(tp["subpixel"]["kernel"],
                              p0["subpixel"]["kernel"])
    import h5py
    with h5py.File(H5, "r") as f:
        np.testing.assert_array_equal(
            tp["subpixel"]["kernel"],
            np.asarray(f["subpixel_1/subpixel_1/kernel"]))


def test_f32_logits_match_jax_on_tiles(jax_loaded, port_loaded):
    net, _, _, jp, js = jax_loaded
    # the JAX tree with the file's depthwise kernels, which its loader skips
    jp = {layer: dict(v) for layer, v in jp.items()}
    for layer, k in _h5_depthwise_kernels().items():
        jp[layer]["depthwise_kernel"] = k
    names = sorted(os.listdir(TILES))[:4]
    x = np.stack([_imread_bgr(os.path.join(TILES, f))[::2, ::2]
                  for f in names]).astype(np.float32)
    want = np.asarray(net.apply_logits(jp, js, jnp.asarray(x))[0])
    got = port_loaded.logits(torch.from_numpy(x), "float32").numpy()
    assert got.shape == want.shape == (4, SZ, SZ, N_CLS)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=min(1e-4, 1e-4 * scale))
