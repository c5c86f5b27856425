"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (listed in
``.gitignore``), at first use, for ``sm_90a``.  The hash covers the source,
every header of ``csrc/`` and the flags, so an edited source or shared
header rebuilds.  Nothing here runs at import
time: the CPU tests import every module of the port on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
# Per-source flags.  These kernels match their plain versions' f32 rounding
# points, so a*b + c must not contract into one fused multiply-add (the CRF
# row blur writes its exact-product multiply-adds as explicit fmaf).
SOURCE_FLAGS = {"crf_fused": ["-fmad=false"],
                "fused_mbconv_train": ["-fmad=false"],
                "fused_dw": ["-fmad=false"]}

_LOADED: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(name: str) -> list:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(_flags(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, final path,
    log path), or None when the library is already built."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = path + ".log"
    with open(log, "w") as lf:
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name), "-o", tmp,
             os.path.join(CSRC, name + ".cu")],
            stdout=lf, stderr=subprocess.STDOUT)
    return proc, tmp, path, log


def build(names) -> dict:
    """Compile every named source, all ``nvcc`` processes started together.
    Returns ``{name: compiler log}`` (empty log when already built); raises
    with the compiler's output if one fails."""
    jobs = {n: _start(n) for n in names}
    logs, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, path, log = job
        rc = proc.wait()
        with open(log) as lf:
            logs[name] = lf.read()
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name} (rc {rc}):\n{logs[name]}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _LOADED[name] = lib
    return lib
