"""Evaluation and visualization (deeplab_tpu/viz.py: reference utils.py:56-71
and the notebook's cells 8-11).

``mIOU`` and ``calculate_iou`` are the notebook's evaluation entry points,
with its per-pixel Python loop replaced by one bincount on the net's device
(``metrics.confusion_matrix``) and the published numbers kept, the
``conf_m[l-1, p-1]`` quirk included.  ``plot_confusion_matrix`` and
``plot_predictions`` import matplotlib when they are called, so the module
imports without it.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from deeplab_tpu_torch.metrics import (confusion_matrix, iou_from_confusion,
                                       mean_iou_published)


def plot_confusion_matrix(cm, classes, normalize=False,
                          title="Confusion matrix", cmap=None):
    """Reference utils.py:56-71 (matplotlib heatmap).  Returns the (possibly
    normalized) matrix, like the reference."""
    import matplotlib.pyplot as plt
    cmap = cmap or plt.cm.Blues
    cm = np.asarray(cm)
    if normalize:
        cm = cm.astype("float") / cm.sum(axis=1)[:, np.newaxis]
    plt.imshow(cm, interpolation="nearest", cmap=cmap)
    plt.title(title, fontsize=11)
    tick_marks = np.arange(len(classes))
    plt.xticks(tick_marks, classes, rotation=90, fontsize=9)
    plt.yticks(tick_marks, classes, fontsize=9)
    thresh = cm.max() / 2.0
    for i, j in itertools.product(range(cm.shape[0]), range(cm.shape[1])):
        plt.text(j, i, np.round(cm[i, j], 2), horizontalalignment="center",
                 color="white" if cm[i, j] > thresh else "black", fontsize=7)
    plt.tight_layout()
    plt.ylabel("True label", fontsize=9)
    plt.xlabel("Predicted label", fontsize=9)
    return cm


def mIOU(gt, preds) -> float:
    """Per-image mean IoU over the labels present in gt (notebook cell 8),
    rounded to 2 decimals."""
    gt = np.asarray(gt)
    preds = np.asarray(preds)
    ulabels = np.unique(gt)
    iou = np.zeros(len(ulabels))
    for k, u in enumerate(ulabels):
        inter = np.sum((gt == u) & (preds == u))
        union = np.sum((gt == u) | (preds == u))
        iou[k] = inter / union if union else 0.0
    return float(np.round(iou.mean(), 2))


def calculate_iou(net, generator, nb_classes: int = 21,
                  ref_shift: bool = True, predict_fn=None):
    """Dataset-level confusion matrix (notebook cell 10).

    ``generator[i]`` gives ``(X, Y, _)`` with X (B, H, W, 3) 0-255 and Y
    (B, H*W, 1) label ids.  ``predict_fn``: ``X -> (B, H*W)`` or ``(B, H, W)``
    label ids, e.g. a ``Predictor`` (with a CRF); by default the net's
    forward argmax under "mixed" on the net's device.  Each batch's matrix is
    one bincount on the device, summed on the host in int64.
    ``ref_shift=True`` returns the notebook's ``conf_m[l-1, p-1]`` matrix, a
    (-1, -1) roll of the standard one, from which the published mean is
    read; the per-class IoU is always in standard class order.  Returns
    (conf_m, per-class IoU, published mean IoU)."""
    dev = next(net.parameters()).device
    if predict_fn is None:
        def predict_fn(X):
            x = torch.as_tensor(np.asarray(X, np.float32)).to(dev)
            return net.predict_ids(x, "mixed")
    conf = np.zeros((nb_classes, nb_classes), np.int64)
    for i in range(len(generator)):
        X, Y, _ = generator[i]
        labels = torch.as_tensor(np.asarray(Y)[..., 0]).to(dev)
        preds = torch.as_tensor(predict_fn(X)).to(dev).reshape(labels.shape)
        conf += confusion_matrix(labels, preds, nb_classes).cpu().numpy()
    conf_ref = np.roll(conf, (-1, -1), axis=(0, 1))     # the cell-10 quirk
    iou = iou_from_confusion(torch.from_numpy(conf.astype(np.float64)))
    mean_iou = mean_iou_published(torch.from_numpy(conf_ref.astype(
        np.float64)))
    return conf_ref if ref_shift else conf, iou.numpy(), float(mean_iou)


# ---------------------------------------------------------- cell-9 figures --

def voc_palette(n: int = 256) -> np.ndarray:
    """The PASCAL VOC devkit color map ((n, 3) uint8), made with the
    devkit's bit-shuffle algorithm."""
    palette = np.zeros((n, 3), np.uint8)
    for i in range(n):
        lbl = i
        r = g = b = 0
        for j in range(8):
            r |= ((lbl >> 0) & 1) << (7 - j)
            g |= ((lbl >> 1) & 1) << (7 - j)
            b |= ((lbl >> 2) & 1) << (7 - j)
            lbl >>= 3
        palette[i] = (r, g, b)
    return palette


def colorize_mask(mask, palette: np.ndarray = None) -> np.ndarray:
    """(H, W) int class-id mask -> (H, W, 3) uint8 VOC-colored image."""
    if palette is None:
        palette = voc_palette()
    return palette[np.asarray(mask).astype(np.int64) % len(palette)]


def plot_predictions(image_bgr, panels, path=None, figsize_per_panel=4):
    """Notebook cell-9 side-by-side figure: the input image, then titled
    masks (e.g. GT / prediction / prediction + CRF), VOC-colorized.

    image_bgr: (H, W, 3) 0-255 BGR; panels: list of (title, (H, W) mask).
    Writes a PNG and closes the figure when ``path`` is given; otherwise
    returns the open figure."""
    import matplotlib.pyplot as plt

    n = 1 + len(panels)
    fig, axes = plt.subplots(1, n, figsize=(figsize_per_panel * n,
                                            figsize_per_panel))
    axes = np.atleast_1d(axes)
    rgb = np.asarray(image_bgr).astype(np.uint8)[..., ::-1]
    axes[0].imshow(rgb)
    axes[0].set_title("image")
    for ax, (title, mask) in zip(axes[1:], panels):
        ax.imshow(colorize_mask(mask))
        ax.set_title(title)
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    return fig
