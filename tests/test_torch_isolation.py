"""The port stands alone: no jax and no deeplab_tpu in its imports, no path
of the JAX package or its native library named in its code (Python or C++)
and no source compiled from outside its own ``csrc`` folders, no silent
CPU fallback, no kernel launch counted on the CPU, and no PIL until an image
is decoded or encoded (the card's machine may lack it)."""

import ast
import os
import re
import subprocess
import sys

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


# a path under the JAX package or its native library: deeplab_tpu/..., or
# native/... as a path's first component
_FOREIGN = re.compile(r"(?<![\w])deeplab_tpu/|(^|[\s\"'(=:]|\.\./)native/"
                      r"|libimgops\.so|DEEPLAB_TPU_IMGOPS")


def _code_strings(path):
    """The string constants of a Python source that are not docstrings."""
    tree = ast.parse(open(path).read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                docs.add(id(first.value))
    return [(n.lineno, n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def _native_sources():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".cpp", ".cu", ".cuh", ".h"))]
    return sorted(out)


@pytest.mark.parametrize("path", [p for p in _sources() if p.startswith(PKG)],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_path_of_the_jax_package_in_code(path):
    bad = [(line, v) for line, v in _code_strings(path) if _FOREIGN.search(v)]
    assert not bad, f"{path} names {bad}"


@pytest.mark.parametrize("path", _native_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_path_of_the_jax_package_in_native_sources(path):
    """C++ and CUDA: no include, and no string, names a JAX-package path
    (comments may cite the file a function mirrors)."""
    for i, line in enumerate(open(path), 1):
        code = line.split("//")[0]
        includes = re.findall(r'#\s*include\s*[<"]([^>"]+)[>"]', code)
        strings = re.findall(r'"([^"]*)"', code)
        bad = [v for v in includes + strings
               if _FOREIGN.search(v) or ".." in v]
        assert not bad, f"{path}:{i} names {bad}"


def test_builds_compile_only_the_ports_sources(tmp_path, monkeypatch):
    """The native library's build and the kernels' builds hand their
    compilers sources under ``deeplab_tpu_torch/data/csrc`` and
    ``deeplab_tpu_torch/kernels/csrc`` only."""
    from deeplab_tpu_torch.data import native
    from deeplab_tpu_torch.kernels import build
    seen = []
    real_run = subprocess.run

    def run(cmd, *a, **kw):
        seen.append(list(cmd))
        return real_run(cmd, *a, **kw)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native.subprocess, "run", run)
    assert native.build().startswith(str(tmp_path))

    class Popen:
        def __init__(self, cmd, **kw):
            seen.append(list(cmd))

        def wait(self):
            return 1
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Popen)
    names = sorted(f[:-3] for f in os.listdir(build.CSRC)
                   if f.endswith(".cu"))
    with pytest.raises(RuntimeError):
        build.build(names)
    allowed = (os.path.join(PKG, "data", "csrc") + os.sep,
               os.path.join(PKG, "kernels", "csrc") + os.sep)
    srcs = [a for cmd in seen for a in cmd
            if a.endswith((".cpp", ".cu", ".c", ".cc"))]
    assert len(srcs) == 1 + len(names), seen
    assert all(os.path.abspath(a).startswith(allowed) for a in srcs), srcs


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


def test_serving_modules_leave_pil_out():
    """Importing the serving surface in a fresh interpreter imports no PIL:
    only decoding and encoding do."""
    code = ("import sys; import deeplab_tpu_torch.serve, "
            "deeplab_tpu_torch.data.augment, deeplab_tpu_torch.data.generator,"
            " deeplab_tpu_torch.predictor; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] == 'PIL'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_package_and_loader_import_no_model_code():
    """``import deeplab_tpu_torch`` and the artifact loader's imports (the
    export module and every kernel operator) leave the model, the CRF and
    the Predictor unimported: ``SegNet`` and ``Predictor`` load when first
    named."""
    code = ("import sys, deeplab_tpu_torch, deeplab_tpu_torch.export as E; "
            "E.OPS.load_all(); print(sorted(m for m in sys.modules if "
            "m.startswith(('deeplab_tpu_torch.models', "
            "'deeplab_tpu_torch.crf', 'deeplab_tpu_torch.predictor')))); "
            "deeplab_tpu_torch.SegNet; print('deeplab_tpu_torch.predictor' "
            "in sys.modules, 'deeplab_tpu_torch.models.seg_model' in "
            "sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "False True"], out.stdout
    import deeplab_tpu_torch
    with pytest.raises(AttributeError):
        deeplab_tpu_torch.NoSuchName


def test_every_serving_kernel_is_an_operator():
    """Each serving launch is a ``deeplab_tpu_torch::`` operator with CPU,
    CUDA and fake implementations."""
    from deeplab_tpu_torch.kernels import ops
    ops.load_all()
    names = ("fused_mbconv", "fused_sepconv", "fused_dw_bn_relu6",
             "splat_planes", "slice_attrs_planes", "blur_rows",
             "gaussian_blur_y_planes", "gaussian_blur_x_planes",
             "mf_step_planes", "mf_step_with_plan", "slice_planes")
    for name in names:
        qual = f"{ops.NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), \
                (qual, key)
