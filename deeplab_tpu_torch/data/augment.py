"""Host-side image resizes in numpy (the port's copy of ``resize_bilinear``
and ``resize_nearest`` of deeplab_tpu/data/augment.py, their numpy path).

They reproduce OpenCV's ``cv2.resize`` with ``INTER_LINEAR`` (half-pixel
centers) and ``INTER_NEAREST``, as the reference generator calls it.  The
JAX package may route uint8 images through its optional native library;
the port keeps the numpy path only.
"""

from __future__ import annotations

import numpy as np


def resize_bilinear(img: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize INTER_LINEAR semantics: half-pixel centers.
    ``size_wh`` is (W, H), the cv2 argument order the reference uses."""
    out_w, out_h = int(size_wh[0]), int(size_wh[1])
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return img.copy()

    def axis_weights(in_size, out_size):
        scale = in_size / out_size
        src = (np.arange(out_size) + 0.5) * scale - 0.5
        lo = np.floor(src).astype(np.int64)
        frac = src - lo
        lo0 = np.clip(lo, 0, in_size - 1)
        lo1 = np.clip(lo + 1, 0, in_size - 1)
        return lo0, lo1, frac.astype(np.float32)

    y0, y1, fy = axis_weights(in_h, out_h)
    x0, x1, fx = axis_weights(in_w, out_w)
    im = img.astype(np.float32)
    if im.ndim == 3:
        fy_ = fy[:, None, None]
        fx_ = fx[None, :, None]
    else:
        fy_ = fy[:, None]
        fx_ = fx[None, :]
    row0 = im[y0][:, x0] * (1 - fx_) + im[y0][:, x1] * fx_
    row1 = im[y1][:, x0] * (1 - fx_) + im[y1][:, x1] * fx_
    out = row0 * (1 - fy_) + row1 * fy_
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), 0,
                       np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize INTER_NEAREST semantics (src = floor(dst * scale))."""
    out_w, out_h = int(size_wh[0]), int(size_wh[1])
    in_h, in_w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_h) * (in_h / out_h))
                    .astype(np.int64), in_h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (in_w / out_w))
                    .astype(np.int64), in_w - 1)
    return img[ys][:, xs].copy()
