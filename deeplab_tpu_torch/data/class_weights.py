"""Balanced class weights (deeplab_tpu/data/class_weights.py): the closed
form that replaces sklearn.

sklearn's ``compute_class_weight('balanced', classes=u, y=y)`` is exactly
``len(y) / (len(u) * bincount(y)[u])``.  The reference calls it per image to
build the adaptive per-pixel weight map (utils.py:389-399) and the fg/bg map
(utils.py:368-386); we reproduce both vectorized.
"""

from __future__ import annotations

import numpy as np


def balanced_class_weights(y: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Closed form of sklearn 'balanced' weights for the present classes."""
    counts = np.bincount(y.astype(np.int64),
                         minlength=int(classes.max()) + 1 if len(classes) else 0)
    return len(y) / (len(classes) * counts[classes].astype(np.float64))


def adaptive_pixel_weights(y: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-pixel weight map (reference utils.py:389-399).

    ``y``: flat int labels in [0, n_classes] (n_classes == void).
    Every pixel of class c gets the balanced weight of c over the non-void
    pixels of this image; void pixels get 0.
    """
    y = y.astype(np.int64)
    sw = np.zeros(y.shape, np.float32)
    valid = y != n_classes
    filt = y[valid]
    if filt.size:
        u = np.unique(filt)
        w = balanced_class_weights(filt, u)
        lut = np.zeros(n_classes + 1, np.float32)
        lut[u] = w.astype(np.float32)
        sw[valid] = lut[y[valid]]
    return sw


def fg_bg_pixel_weights(y: np.ndarray, n_classes: int) -> np.ndarray:
    """Foreground/background-balanced map (reference utils.py:368-386; dead
    code upstream — never returned — but part of the generator's surface)."""
    y = y.astype(np.int64)
    fg = (y != 0).astype(np.int64)
    valid = y != n_classes
    fgv = fg[valid]
    u = np.unique(fgv)
    weights = {}
    if fgv.size:
        w = balanced_class_weights(fgv, u)
        weights = {int(c): float(x) for c, x in zip(u, w)}
    if len(weights) == 1:           # no bg or no fg (utils.py:373-377)
        if 1 in weights:
            weights[0] = 0.0
        else:
            weights[1] = 0.0
    elif not weights:               # empty image (utils.py:378-380)
        weights = {0: 0.0, 1: 0.0}
    sw = np.ones(y.shape, np.float32)
    sw[y == 0] = weights[0]
    sw[fg == 1] = weights[1]
    sw[y == n_classes] = 0.0
    return sw
