"""ctypes bindings for the native host image library
(``data/csrc/imgops.cpp``; JAX ``deeplab_tpu/data/native.py``).

The library is the equivalent of the reference's OpenCV C++ layer:
``augment.py`` sends uint8 images through these functions when it is
available and keeps its numpy path otherwise.  It is built with ``g++``
(``$CXX`` where set) at first use into ``build/native/`` at the root of the
checkout (listed in ``.gitignore``), under a name that carries a hash of
the source and the flags; the compiler writes a temporary file that
``os.replace`` moves into place, so processes that build at once each get
a whole library.  A build that fails leaves the numpy path, with one
warning a process carrying the compiler's message.

The flags keep the rounding of every host alike: no ``-march=native`` (the
x86-64 baseline has no FMA) and ``-ffp-contract=off`` (no host contracts
``a * b + c`` into one fused multiply-add), so the float paths round each
product and sum as the source writes them, on any machine.

Nothing is built at import: the tests import every module of the port.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import warnings
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "imgops.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "native")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
BUILD_LOG = ""      # the compiler's output of this process's build
BUILD_SECONDS = None  # how long this process's compile took, if it ran one


def _cxx() -> Optional[str]:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def lib_path() -> str:
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libimgops-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library where it is not built yet; returns its path.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    global BUILD_LOG, BUILD_SECONDS
    path = lib_path()
    if os.path.exists(path):
        return path
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++, c++ or $CXX)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = out.stdout + out.stderr
        if out.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cxx)} failed (rc "
                               f"{out.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, i32, i64 = (ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                     ctypes.c_int64)
    lib.resize_bilinear_u8.argtypes = [u8p, i32, i32, i32, u8p, i32, i32]
    lib.resize_nearest_u8.argtypes = lib.resize_bilinear_u8.argtypes
    lib.flip_u8.argtypes = [u8p, i32, i32, i32, i32, u8p]
    lib.lut_u8.argtypes = [u8p, i64, u8p, u8p]
    lib.warp_affine_u8.argtypes = [u8p, i32, i32, i32,
                                   ctypes.POINTER(ctypes.c_double), u8p,
                                   i32, i32, i32]
    lib.gaussian_blur_u8.argtypes = [u8p, i32, i32, i32, i32, u8p]
    lib.bgr2yuv_u8.argtypes = [u8p, i64, u8p]
    lib.yuv2bgr_u8.argtypes = lib.bgr2yuv_u8.argtypes
    lib.clahe_u8.argtypes = [u8p, i32, i32, ctypes.c_double, i32, i32, u8p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None where it does not
    build (warned once) or while :func:`masked`."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        _LIB = _bind(ctypes.CDLL(build()))
    except (OSError, RuntimeError) as e:
        warnings.warn(f"the native image library did not build; augment.py "
                      f"keeps its numpy path: {e}", RuntimeWarning,
                      stacklevel=2)
        _LIB = None
    return _LIB


def available() -> bool:
    return load() is not None


@contextlib.contextmanager
def masked():
    """Within the block, :func:`available` is false in this process (the
    numpy path runs), whether or not the library is built."""
    global _LIB, _TRIED
    lib, tried = load(), _TRIED
    _LIB, _TRIED = None, True
    try:
        yield
    finally:
        _LIB, _TRIED = lib, tried


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _hwc(img: np.ndarray):
    h, w = img.shape[:2]
    return h, w, (img.shape[2] if img.ndim == 3 else 1)


def _resize(fn, img: np.ndarray, size_wh) -> np.ndarray:
    img = np.ascontiguousarray(img)
    h, w, c = _hwc(img)
    ow, oh = int(size_wh[0]), int(size_wh[1])
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    fn(_u8p(img), h, w, c, _u8p(out), oh, ow)
    return out


def resize_bilinear(img: np.ndarray, size_wh) -> np.ndarray:
    """cv2 INTER_LINEAR; ``size_wh`` is (W, H)."""
    return _resize(load().resize_bilinear_u8, img, size_wh)


def resize_nearest(img: np.ndarray, size_wh) -> np.ndarray:
    """cv2 INTER_NEAREST; ``size_wh`` is (W, H)."""
    return _resize(load().resize_nearest_u8, img, size_wh)


def flip(img: np.ndarray, axis: int) -> np.ndarray:
    img = np.ascontiguousarray(img)
    h, w, c = _hwc(img)
    out = np.empty_like(img)
    load().flip_u8(_u8p(img), h, w, c, axis, _u8p(out))
    return out


def apply_lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    table = np.ascontiguousarray(table, np.uint8)
    out = np.empty_like(img)
    load().lut_u8(_u8p(img), img.size, _u8p(table), _u8p(out))
    return out


def warp_affine(img: np.ndarray, M: np.ndarray, size_wh,
                nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine with ``M`` mapping src to dst, constant-0 border."""
    img = np.ascontiguousarray(img)
    h, w, c = _hwc(img)
    ow, oh = int(size_wh[0]), int(size_wh[1])
    M = np.ascontiguousarray(M, np.float64)
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    load().warp_affine_u8(_u8p(img), h, w, c,
                          M.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                          _u8p(out), oh, ow, int(nearest))
    return out


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    img = np.ascontiguousarray(img)
    h, w, c = _hwc(img)
    out = np.empty_like(img)
    load().gaussian_blur_u8(_u8p(img), h, w, c, ksize, _u8p(out))
    return out


def bgr_to_yuv(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    out = np.empty_like(img)
    load().bgr2yuv_u8(_u8p(img), img.shape[0] * img.shape[1], _u8p(out))
    return out


def yuv_to_bgr(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    out = np.empty_like(img)
    load().yuv2bgr_u8(_u8p(img), img.shape[0] * img.shape[1], _u8p(out))
    return out


def clahe(channel: np.ndarray, clip_limit: float = 2.0, tiles=(8, 8)
          ) -> np.ndarray:
    channel = np.ascontiguousarray(channel)
    h, w = channel.shape
    out = np.empty_like(channel)
    load().clahe_u8(_u8p(channel), h, w, float(clip_limit), tiles[0],
                    tiles[1], _u8p(out))
    return out
