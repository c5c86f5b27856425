"""Exact dense-CRF mean-field in numpy, the O(N^2) oracle for CRF tests
(the port's own copy of deeplab_tpu/crf/brute.py).

Implements Krähenbühl & Koltun (NIPS 2011) Algorithm 1 with the conventions
the reference's pydensecrf call uses (utils.py:74-91):

- unary from a hard label map, gt_prob=0.7 (``unary_from_labels``)
- kernel 1: spatial Gaussian, sxy=(3,3), Potts compat 3
- kernel 2: bilateral (x,y,r,g,b), sxy=80, srgb=13, Potts compat 10
- symmetric kernel normalization (densecrf NORMALIZE_SYMMETRIC default)
- self-interaction excluded; 5 iterations

Exact pairwise sums make this O(N^2 * L) — only for small test images.
"""

from __future__ import annotations

import numpy as np


def unary_from_labels_np(labels: np.ndarray, n_labels: int, gt_prob: float,
                         zero_unsure: bool = True) -> np.ndarray:
    """pydensecrf.utils.unary_from_labels semantics. labels flat int array.
    Returns U with shape (n_labels, N) (energies, i.e. -log p)."""
    assert 0 < gt_prob < 1
    labels = labels.reshape(-1)
    n_energy = -np.log((1.0 - gt_prob) / (n_labels - 1))
    p_energy = -np.log(gt_prob)
    U = np.full((n_labels, labels.size), n_energy, dtype=np.float32)
    idx = labels - 1 if zero_unsure else labels
    U[idx, np.arange(U.shape[1])] = p_energy
    if zero_unsure:
        U[:, labels == 0] = -np.log(1.0 / n_labels)
    return U


def _features(im: np.ndarray, sxy: float, srgb: float | None):
    h, w = im.shape[:2]
    ys, xs = np.mgrid[:h, :w]
    feats = [xs.reshape(-1) / sxy, ys.reshape(-1) / sxy]
    if srgb is not None:
        for c in range(3):
            feats.append(im[..., c].reshape(-1).astype(np.float64) / srgb)
    return np.stack(feats, axis=1)  # (N, d)


def _kernel_matrix(feats: np.ndarray, exclude_self: bool = True) -> np.ndarray:
    d2 = np.sum((feats[:, None, :] - feats[None, :, :]) ** 2, axis=-1)
    K = np.exp(-0.5 * d2)
    if exclude_self:
        np.fill_diagonal(K, 0.0)
    return K


def _normalize_symmetric(K: np.ndarray) -> np.ndarray:
    norm = 1.0 / np.sqrt(K.sum(axis=1) + 1e-20)
    return K * norm[:, None] * norm[None, :]


def exact_mean_field(im: np.ndarray, unary: np.ndarray, n_iters: int = 5,
                     sxy_gaussian: float = 3.0, compat_gaussian: float = 3.0,
                     sxy_bilateral: float = 80.0, srgb: float = 13.0,
                     compat_bilateral: float = 10.0,
                     exclude_self: bool = True) -> np.ndarray:
    """Returns Q with shape (L, N).  ``unary`` is (L, N) energies."""
    Kg = _normalize_symmetric(
        _kernel_matrix(_features(im, sxy_gaussian, None), exclude_self))
    Kb = _normalize_symmetric(
        _kernel_matrix(_features(im, sxy_bilateral, srgb), exclude_self))

    def softmax(x):
        e = np.exp(x - x.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)

    Q = softmax(-unary)
    for _ in range(n_iters):
        msg = compat_gaussian * (Q @ Kg.T) + compat_bilateral * (Q @ Kb.T)
        Q = softmax(-unary + msg)
    return Q


def exact_crf_map(im: np.ndarray, mask: np.ndarray, zero_unsure: bool = True,
                  n_iters: int = 5, **kw) -> np.ndarray:
    """Full do_crf oracle (utils.py:74-91): label compression -> unary ->
    mean field -> argmax -> remap to original ids."""
    colors, labels = np.unique(mask, return_inverse=True)
    n_labels = len(set(labels.flat))
    if n_labels == 1:
        # single-label mask: nothing to refine (matches do_crf's guard;
        # the two-level unary is undefined for n_labels == 1)
        return mask.copy()
    U = unary_from_labels_np(labels, n_labels, gt_prob=0.7,
                             zero_unsure=zero_unsure)
    Q = exact_mean_field(im, U, n_iters=n_iters, **kw)
    MAP = np.argmax(Q, axis=0).reshape(mask.shape[:2])
    out = MAP.copy()
    for u in np.unique(MAP):
        out[MAP == u] = colors[u]
    return out
