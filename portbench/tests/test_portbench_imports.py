"""The benchmark imports neither JAX nor the JAX package, and its plain
reference nothing of the program under test."""

import ast
import os

import pytest

from portbench import harness as H

PB = os.path.join(H.ROOT, "portbench")
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(PB) for f in fs
               if f.endswith(".py"))


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, PB) for p in FILES])
def test_no_jax(path):
    assert not set(_top_level_imports(path)) & {"jax", "jaxlib", "flax",
                                                "deeplab_tpu"}


@pytest.mark.parametrize("path", [p for p in FILES
                                  if os.sep + "reference" + os.sep in p])
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_level_imports(path))
    assert names <= {"__future__", "math", "numpy", "torch", "scipy",
                     "portbench"}
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")
