"""The port's numpy CRF oracle (``deeplab_tpu_torch/crf/brute.py``) against
the JAX package's (``deeplab_tpu/crf/brute.py``) on the five
``tests/goldens/crf`` scenes.

The oracle is O(N^2) in memory (an (N, N, 5) float64 difference array), so
each scene is held at a 32x40 window of its center (N = 1280): the unary
energies and the mean field's Q within 1e-6, the MAPs equal.  The 48x48
scene is also run whole through the port's ``exact_crf_map`` at the
goldens' conventions (``zero_unsure=False``) and must reproduce its
committed golden exactly.
"""

import os

import numpy as np
import pytest

from crf_scenes import SCENES, make_scene
from deeplab_tpu.crf import brute as JB

from deeplab_tpu_torch.crf import brute as TB

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens", "crf")
WIN = (32, 40)


def _window(scene):
    name, H, W, L, seed = scene
    im, mask = make_scene(H, W, L, seed)
    y0, x0 = (H - WIN[0]) // 2, (W - WIN[1]) // 2
    return (im[y0:y0 + WIN[0], x0:x0 + WIN[1]],
            mask[y0:y0 + WIN[0], x0:x0 + WIN[1]], L)


@pytest.mark.parametrize("scene", SCENES, ids=[s[0] for s in SCENES])
def test_oracle_matches_jax_on_each_scene(scene):
    im, mask, L = _window(scene)
    for zero_unsure in (False, True):
        np.testing.assert_array_equal(
            TB.unary_from_labels_np(mask, L, 0.7, zero_unsure),
            JB.unary_from_labels_np(mask, L, 0.7, zero_unsure))
    U = TB.unary_from_labels_np(mask, L, 0.7, zero_unsure=False)
    q = TB.exact_mean_field(im, U)
    want = JB.exact_mean_field(im, U)
    assert q.shape == (L, mask.size)
    np.testing.assert_allclose(q, want, rtol=0, atol=1e-6)
    got = TB.exact_crf_map(im, mask, zero_unsure=False)
    np.testing.assert_array_equal(got, JB.exact_crf_map(im, mask,
                                                        zero_unsure=False))
    assert (got != mask).any()      # the CRF refined something


def test_oracle_reproduces_the_committed_golden():
    name, H, W, L, seed = SCENES[0]
    assert (H, W) == (48, 48)
    im, mask = make_scene(H, W, L, seed)
    golden = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["golden"]
    np.testing.assert_array_equal(TB.exact_crf_map(im, mask,
                                                   zero_unsure=False),
                                  golden)


def test_single_label_mask_is_returned_unchanged():
    im = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32) * 255
    mask = np.full((8, 8), 4)
    np.testing.assert_array_equal(TB.exact_crf_map(im, mask), mask)
