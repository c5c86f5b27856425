"""The port stands alone: no jax and no deeplab_tpu in its imports, no silent
CPU fallback, and no kernel launch counted on the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplab_tpu_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "deeplab_tpu")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_predictor_defaults_to_the_card():
    from deeplab_tpu_torch import Predictor, SegNet
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(SegNet((16, 16), 3))


def test_cpu_forward_counts_no_launch():
    from deeplab_tpu_torch import Predictor, SegNet
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    before = FM.fused_mbconv.launches
    out = Predictor(SegNet((32, 32), 3), device="cpu")(
        np.random.RandomState(0).rand(2, 32, 32, 3) * 255)
    assert out.shape == (2, 32, 32)
    assert FM.fused_mbconv.launches == before == 0
