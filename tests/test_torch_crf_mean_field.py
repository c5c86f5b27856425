"""The port's ``mean_field_batched`` end to end on the CPU (the plain
versions of its four kernels in the kernels' places).

- Against the JAX package with ``backend="pallas"`` (its Pallas kernels in
  interpret mode; ``"auto"`` would pick the XLA engine on the CPU, whose
  square cells legitimately diverge, tests/test_crf_pallas.py) at
  ``PRODUCTION_CONFIG`` on structured scenes at 128x256, B=2, 21 labels:
  mask agreement >= 0.995 (measured 1.0).
- Against the committed exact-oracle goldens (tests/goldens/crf, the O(N^2)
  mean field of crf/brute.py) at ``FAST_FAITHFUL_CONFIG``: >= 0.993 on each
  of the five scenes, the floor of tests/test_crf_goldens.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crf_scenes import SCENES, make_scene
from deeplab_tpu import crf as JCRF
from deeplab_tpu.crf.dense_crf import mean_field_batched as jax_mfb

from deeplab_tpu_torch import crf as TCRF

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens", "crf")


def test_production_matches_jax_pallas():
    ims, ms = zip(*[make_scene(128, 256, 21, s) for s in (11, 12)])
    im, mask = np.stack(ims), np.stack(ms)
    cfg = dataclasses.replace(JCRF.PRODUCTION_CONFIG, backend="pallas")
    want = np.asarray(jax_mfb(jnp.asarray(im), jnp.asarray(mask), cfg, 21))
    got = TCRF.mean_field_batched(torch.from_numpy(im),
                                  torch.from_numpy(mask),
                                  TCRF.PRODUCTION_CONFIG, 21)
    assert got.dtype == torch.int32 and got.shape == mask.shape
    agree = float((got.numpy() == want).mean())
    changed = float((want != mask).mean())
    print(f"production mask agreement with JAX: {agree:.5f} "
          f"(the CRF changed {changed:.4f} of the pixels)")
    assert changed > 0.01          # the CRF did something to agree on
    assert agree >= 0.995, agree


@pytest.mark.parametrize("scene", SCENES, ids=[s[0] for s in SCENES])
def test_fast_faithful_matches_oracle_goldens(scene):
    name, H, W, L, seed = scene
    golden = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["golden"]
    im, mask = make_scene(H, W, L, seed)
    out = TCRF.mean_field_batched(torch.from_numpy(im)[None],
                                  torch.from_numpy(mask)[None],
                                  TCRF.FAST_FAITHFUL_CONFIG, L)[0].numpy()
    agree = float((out == golden).mean())
    print(f"{name}: oracle agreement {agree:.5f}")
    assert agree >= 0.993, (name, agree)


@pytest.mark.parametrize("name", ["THROUGHPUT_CONFIG", "FAITHFUL_CONFIG"])
def test_other_configs_match_jax_pallas(name):
    """The other plane geometries (nc 9 with a 4x splat stride, nc 21 with
    gaussian taps) on a padded 80x120 scene."""
    im, mask = make_scene(80, 120, 11, 7)
    cfg = dataclasses.replace(getattr(JCRF, name), backend="pallas")
    want = np.asarray(jax_mfb(jnp.asarray(im)[None], jnp.asarray(mask)[None],
                              cfg, 11))[0]
    got = TCRF.mean_field_batched(torch.from_numpy(im)[None],
                                  torch.from_numpy(mask)[None],
                                  getattr(TCRF, name), 11)[0].numpy()
    agree = float((got == want).mean())
    print(f"{name} mask agreement with JAX: {agree:.5f}")
    assert agree >= 0.995, agree
