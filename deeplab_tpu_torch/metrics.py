"""Metrics with the reference's semantics (deeplab_tpu/metrics.py).

- ``sparse_accuracy_ignoring_last_label``: pixel accuracy over non-void
  pixels.
- ``Jaccard``: per-class IoU, each class averaged only over the batch items
  that contain it (legal batches); classes in no item are dropped.  The
  mean includes background.
- ``confusion_matrix``: the dataset-level evaluation of the notebook's cell
  10 as one ``torch.bincount`` on the device, with the reference's
  ``conf_m[l-1, p-1]`` index shift on request; ``iou_from_confusion`` and
  the published mean, ``mean_iou_published``.

Everything stays on the device: the Trainer accumulates these tensors and
reads them once per epoch.
"""

from __future__ import annotations

import torch


def sparse_accuracy_ignoring_last_label(y_true, y_pred):
    """y_true: (B, N, 1) ids; y_pred: (B, N, C) probabilities or logits."""
    nb_classes = y_pred.shape[-1]
    pred = torch.argmax(y_pred.reshape(-1, nb_classes), dim=-1)
    return accuracy_from_ids(y_true.reshape(-1), pred, nb_classes)


def Jaccard(y_true, y_pred):
    """Mean IoU with legal-batch semantics; y_true (B, N, 1), y_pred
    (B, N, C)."""
    nb_classes = y_pred.shape[-1]
    return jaccard_from_ids(y_true[..., 0], torch.argmax(y_pred, dim=-1),
                            nb_classes)


def accuracy_sums_from_ids(labels, pred, nb_classes: int):
    """(correct_count, legal_count) partial sums of the masked accuracy."""
    labels = labels.reshape(-1).long()
    pred = pred.reshape(-1).long()
    legal = labels != nb_classes
    correct = torch.sum((legal & (labels == pred)).float())
    return correct, torch.sum(legal.float())


def accuracy_from_ids(labels, pred, nb_classes: int):
    """Masked pixel accuracy from label and prediction id arrays."""
    correct, legal = accuracy_sums_from_ids(labels, pred, nb_classes)
    return correct / torch.clamp(legal, min=1.0)


def jaccard_counts_from_ids(labels, pred, nb_classes: int):
    """Per item and class (B, C): intersection, union and the labelled
    pixel count, as float32; labels and pred are (B, N) ids.  Counts of an
    item's parts (bands of its rows) add up to the item's."""
    labels = labels.long()
    pred = pred.long()
    class_ids = torch.arange(nb_classes, device=labels.device)
    true_oh = labels[..., None] == class_ids              # (B, N, C)
    pred_oh = pred[..., None] == class_ids
    inter = torch.sum(true_oh & pred_oh, dim=1).float()   # (B, C)
    union = torch.sum(true_oh | pred_oh, dim=1).float()
    return inter, union, torch.sum(true_oh, dim=1).float()


def jaccard_sums_from_counts(inter, union, present):
    """Per-class (iou_sum, legal_count) over batch items from their
    :func:`jaccard_counts_from_ids`."""
    legal = present > 0
    ious = inter / torch.clamp(union, min=1.0)
    n_legal = torch.sum(legal.float(), dim=0)
    return torch.sum(torch.where(legal, ious, 0.0), dim=0), n_legal


def jaccard_sums_from_ids(labels, pred, nb_classes: int):
    """Per-class (iou_sum, legal_count) over batch items; labels and pred
    are (B, N) ids."""
    return jaccard_sums_from_counts(*jaccard_counts_from_ids(labels, pred,
                                                             nb_classes))


def jaccard_from_sums(iou_sum, n_legal):
    """Average per class over legal items; drop classes in no item."""
    class_iou = iou_sum / torch.clamp(n_legal, min=1.0)
    valid = n_legal > 0
    return torch.sum(torch.where(valid, class_iou, 0.0)) / torch.clamp(
        torch.sum(valid.float()), min=1.0)


def jaccard_from_ids(labels, pred, nb_classes: int):
    """Mean IoU from (B, N) id maps."""
    return jaccard_from_sums(*jaccard_sums_from_ids(labels, pred, nb_classes))


def confusion_matrix(labels, preds, n_classes: int, ref_shift: bool = False):
    """(n_classes, n_classes) int64 confusion matrix, rows the labels, as one
    bincount on the device of ``labels``.  Void pixels (label ==
    n_classes) are left out.  ``ref_shift`` reproduces the notebook's
    ``conf_m[l-1, p-1] += 1`` (label and prediction 0 wrap to the last row
    and column)."""
    labels = labels.reshape(-1).long()
    preds = preds.reshape(-1).long().to(labels.device)
    keep = labels < n_classes
    if ref_shift:
        labels = (labels - 1) % n_classes
        preds = (preds - 1) % n_classes
    idx = torch.where(keep, labels * n_classes + preds, n_classes * n_classes)
    counts = torch.bincount(idx, minlength=n_classes * n_classes + 1)
    return counts[:n_classes * n_classes].reshape(n_classes, n_classes)


def iou_from_confusion(conf_m):
    """Per-class IoU = diag / (rowsum + colsum - diag) (notebook cell 10),
    in f32."""
    conf_m = conf_m.float()
    diag = torch.diagonal(conf_m)
    denom = conf_m.sum(dim=1) + conf_m.sum(dim=0) - diag
    return diag / torch.clamp(denom, min=1.0)


def mean_iou_published(conf_m):
    """The reference's published "Mean IOU": the mean of the row-normalized
    confusion matrix's diagonal (notebook cell 11), in f32."""
    conf_m = conf_m.float()
    row = conf_m / torch.clamp(conf_m.sum(dim=1, keepdim=True), min=1.0)
    return torch.mean(torch.diagonal(row))
