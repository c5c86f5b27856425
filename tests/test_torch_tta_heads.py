"""The port's test-time augmentation with the 'subpixel' head and the
Xception trunk (output stride 16) against the JAX package's, on the CPU, in
float32, on the same calibrated weights; the weights, the rebuilt JAX sums
and the tolerances are tests/test_torch_tta.py's (its docstring).
"""

import pytest

from test_torch_tta import calibrated_nets, check_tta


@pytest.fixture(scope="module")
def nets():
    return calibrated_nets(("subpixel", "xception"))


@pytest.mark.parametrize("kind", ["subpixel", "xception"])
def test_tta_matches_jax(nets, kind):
    check_tta(nets, None, kind, (0.75, 1.0), True)
