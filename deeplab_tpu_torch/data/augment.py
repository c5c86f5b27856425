"""Host-side image ops (the port's copy of deeplab_tpu/data/augment.py).

Each op reproduces the cv2 call the reference generator makes
(utils.py:315-358): bilinear/nearest resize (``cv2.resize`` with
``INTER_LINEAR``, half-pixel centers, and ``INTER_NEAREST``), flips, gamma
LUT, fused rotation+zoom affine warp, Gaussian blur, CLAHE on the Y channel
of YUV.  As in the JAX package, uint8 images go through the native
library (``data/native.py``) where it is available, and through the numpy
code below otherwise: the same conditions, op by op.
"""

from __future__ import annotations

import numpy as np

from deeplab_tpu_torch.data import native as _native


def resize_bilinear(img: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize INTER_LINEAR semantics: half-pixel centers.
    ``size_wh`` is (W, H), the cv2 argument order the reference uses."""
    out_w, out_h = int(size_wh[0]), int(size_wh[1])
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return img.copy()
    if img.dtype == np.uint8 and _native.available():
        return _native.resize_bilinear(img, size_wh)

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
    if img.dtype == np.uint8 and _native.available():
        return _native.resize_nearest(img, size_wh)
    ys = np.minimum(np.floor(np.arange(out_h) * (in_h / out_h))
                    .astype(np.int64), in_h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (in_w / out_w))
                    .astype(np.int64), in_w - 1)
    return img[ys][:, xs].copy()


# ----------------------------------------------------------------- flips ----

def flip_horizontal(img: np.ndarray) -> np.ndarray:   # cv2.flip(img, 1)
    if img.dtype == np.uint8 and _native.available():
        return _native.flip(img, 1)
    return img[:, ::-1].copy()


def flip_vertical(img: np.ndarray) -> np.ndarray:     # cv2.flip(img, 0)
    if img.dtype == np.uint8 and _native.available():
        return _native.flip(img, 0)
    return img[::-1].copy()


# ------------------------------------------------------------- gamma LUT ----

def gamma_lut(factor: float) -> np.ndarray:
    """Reference brightness table (utils.py:340): ((i/255)**factor)*255."""
    i = np.arange(256, dtype=np.float64)
    return (((i / 255.0) ** factor) * 255.0).astype(np.uint8)


def apply_lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8 and _native.available():
        return _native.apply_lut(img, table)
    return table[img]


# ----------------------------------------------------------- affine warp ----

def rotation_matrix(center_xy, angle_deg: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: rotation about center + isotropic zoom."""
    a = scale * np.cos(np.deg2rad(angle_deg))
    b = scale * np.sin(np.deg2rad(angle_deg))
    cx, cy = center_xy
    return np.array([[a, b, (1 - a) * cx - b * cy],
                     [-b, a, b * cx + (1 - a) * cy]], np.float64)


def warp_affine(img: np.ndarray, M: np.ndarray, size_wh, nearest: bool = False
                ) -> np.ndarray:
    """cv2.warpAffine: M maps src->dst; sample dst pixels at M^{-1} dst,
    bilinear (default, as the reference uses for images AND labels) or
    nearest, constant-0 border."""
    out_w, out_h = int(size_wh[0]), int(size_wh[1])
    if img.dtype == np.uint8 and _native.available():
        return _native.warp_affine(img, M, size_wh, nearest)
    Mi = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    xs, ys = np.meshgrid(np.arange(out_w), np.arange(out_h))
    sx = Mi[0, 0] * xs + Mi[0, 1] * ys + Mi[0, 2]
    sy = Mi[1, 0] * xs + Mi[1, 1] * ys + Mi[1, 2]
    in_h, in_w = img.shape[:2]

    if nearest:
        ix = np.rint(sx).astype(np.int64)
        iy = np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < in_w) & (iy >= 0) & (iy < in_h)
        ix = np.clip(ix, 0, in_w - 1)
        iy = np.clip(iy, 0, in_h - 1)
        out = img[iy, ix]
        out[~inside] = 0
        return out

    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)

    def sample(yy, xx):
        inside = (xx >= 0) & (xx < in_w) & (yy >= 0) & (yy < in_h)
        v = img[np.clip(yy, 0, in_h - 1), np.clip(xx, 0, in_w - 1)]
        v = v.astype(np.float32)
        v[~inside] = 0.0   # broadcasts over channels when present
        return v

    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    out = (sample(y0, x0) * (1 - fx) * (1 - fy) +
           sample(y0, x0 + 1) * fx * (1 - fy) +
           sample(y0 + 1, x0) * (1 - fx) * fy +
           sample(y0 + 1, x0 + 1) * fx * fy)
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), 0, np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


# --------------------------------------------------------- Gaussian blur ----

_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel: fixed binomial taps for ksize<=7 with sigma<=0,
    else sigma = 0.3*((k-1)*0.5 - 1) + 0.8."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return np.asarray(_SMALL_GAUSSIAN_TAB[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k,k), 0) with BORDER_REFLECT_101."""
    if img.dtype == np.uint8 and _native.available():
        return _native.gaussian_blur(img, ksize)
    k = gaussian_kernel_1d(ksize)
    pad = ksize // 2
    im = img.astype(np.float64)
    axes = ((pad, pad), (pad, pad)) + (((0, 0),) if im.ndim == 3 else ())
    im = np.pad(im, axes, mode="reflect")
    # separable: rows then cols
    im = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, im)
    im = np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, im)
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(im), 0, np.iinfo(img.dtype).max).astype(img.dtype)
    return im.astype(img.dtype)


# -------------------------------------------------------- color + CLAHE ----

def bgr_to_yuv(img: np.ndarray) -> np.ndarray:
    """cv2.COLOR_BGR2YUV (uint8, delta=128)."""
    if img.dtype == np.uint8 and _native.available():
        return _native.bgr_to_yuv(img)
    b, g, r = img[..., 0].astype(np.float64), img[..., 1].astype(np.float64), \
        img[..., 2].astype(np.float64)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 0.492 * (b - y) + 128.0
    v = 0.877 * (r - y) + 128.0
    return np.clip(np.rint(np.stack([y, u, v], -1)), 0, 255).astype(np.uint8)


def yuv_to_bgr(img: np.ndarray) -> np.ndarray:
    """cv2.COLOR_YUV2BGR."""
    if img.dtype == np.uint8 and _native.available():
        return _native.yuv_to_bgr(img)
    y = img[..., 0].astype(np.float64)
    u = img[..., 1].astype(np.float64) - 128.0
    v = img[..., 2].astype(np.float64) - 128.0
    r = y + 1.140 * v
    g = y - 0.395 * u - 0.581 * v
    b = y + 2.032 * u
    return np.clip(np.rint(np.stack([b, g, r], -1)), 0, 255).astype(np.uint8)


def clahe(channel: np.ndarray, clip_limit: float = 2.0, tiles=(8, 8)
          ) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization on one uint8 channel
    (cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8,8)), utils.py:53).

    Per-tile 256-bin histogram -> clip at clip_limit * tile_px / 256 with
    uniform redistribution of the excess -> CDF lookup tables -> bilinear
    interpolation between the four surrounding tile mappings.
    """
    h, w = channel.shape
    if channel.dtype == np.uint8 and _native.available():
        return _native.clahe(channel, clip_limit, tiles)
    th, tw = tiles
    # cv2 pads the image so tiles divide evenly (border reflect 101)
    ph = (th - h % th) % th
    pw = (tw - w % tw) % tw
    img = np.pad(channel, ((0, ph), (0, pw)), mode="reflect") if (ph or pw) \
        else channel
    H, W = img.shape
    tile_h, tile_w = H // th, W // tw
    n_px = tile_h * tile_w
    clip = max(int(clip_limit * n_px / 256), 1)

    luts = np.zeros((th, tw, 256), np.float64)
    for i in range(th):
        for j in range(tw):
            tile = img[i * tile_h:(i + 1) * tile_h, j * tile_w:(j + 1) * tile_w]
            hist = np.bincount(tile.reshape(-1), minlength=256).astype(np.int64)
            excess = np.sum(np.maximum(hist - clip, 0))
            hist = np.minimum(hist, clip)
            # uniform redistribution (cv2 adds excess//256 to every bin,
            # remainder to the first bins)
            hist += excess // 256
            rem = int(excess % 256)
            if rem:
                step = max(256 // rem, 1)
                hist[::step][:rem] += 1
            cdf = np.cumsum(hist)
            luts[i, j] = np.clip(np.rint(cdf * (255.0 / n_px)), 0, 255)

    # bilinear interpolation between tile LUTs, tile centers as knots
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ty = (ys - tile_h / 2) / tile_h
    tx = (xs - tile_w / 2) / tile_w
    y0 = np.clip(np.floor(ty).astype(np.int64), 0, th - 1)
    x0 = np.clip(np.floor(tx).astype(np.int64), 0, tw - 1)
    y1 = np.clip(y0 + 1, 0, th - 1)
    x1 = np.clip(x0 + 1, 0, tw - 1)
    fy = np.clip(ty - y0, 0, 1)
    fx = np.clip(tx - x0, 0, 1)

    v = img.reshape(-1)
    idx = np.arange(v.size)
    out = (luts[y0.reshape(-1), x0.reshape(-1), v] * ((1 - fy) * (1 - fx)).reshape(-1) +
           luts[y0.reshape(-1), x1.reshape(-1), v] * ((1 - fy) * fx).reshape(-1) +
           luts[y1.reshape(-1), x0.reshape(-1), v] * (fy * (1 - fx)).reshape(-1) +
           luts[y1.reshape(-1), x1.reshape(-1), v] * (fy * fx).reshape(-1))
    out = np.clip(np.rint(out.reshape(H, W)), 0, 255).astype(np.uint8)
    return out[:h, :w]


def clahe_bgr(image: np.ndarray, clip_limit: float = 2.0, tiles=(8, 8)
              ) -> np.ndarray:
    """The reference's histeq step (utils.py:355-358): CLAHE on YUV-Y,
    output stays BGR."""
    yuv = bgr_to_yuv(image)
    yuv[..., 0] = clahe(yuv[..., 0], clip_limit, tiles)
    return yuv_to_bgr(yuv)
