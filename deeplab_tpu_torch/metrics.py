"""Step metrics with the reference's semantics (deeplab_tpu/metrics.py).

- Pixel accuracy over non-void pixels.
- ``Jaccard``: per-class IoU, each class averaged only over the batch items
  that contain it (legal batches); classes in no item are dropped.  The
  mean includes background.

Everything stays on the device: the Trainer accumulates these tensors and
reads them once per epoch.
"""

from __future__ import annotations

import torch


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


def jaccard_sums_from_ids(labels, pred, nb_classes: int):
    """Per-class (iou_sum, legal_count) over batch items; labels and pred
    are (B, N) ids."""
    labels = labels.long()
    pred = pred.long()
    class_ids = torch.arange(nb_classes, device=labels.device)
    true_oh = labels[..., None] == class_ids              # (B, N, C)
    pred_oh = pred[..., None] == class_ids
    inter = torch.sum(true_oh & pred_oh, dim=1).float()   # (B, C)
    union = torch.sum(true_oh | pred_oh, dim=1).float()
    legal = torch.sum(true_oh, dim=1) > 0
    ious = inter / torch.clamp(union, min=1.0)
    n_legal = torch.sum(legal.float(), dim=0)
    return torch.sum(torch.where(legal, ious, 0.0), dim=0), n_legal


def jaccard_from_sums(iou_sum, n_legal):
    """Average per class over legal items; drop classes in no item."""
    class_iou = iou_sum / torch.clamp(n_legal, min=1.0)
    valid = n_legal > 0
    return torch.sum(torch.where(valid, class_iou, 0.0)) / torch.clamp(
        torch.sum(valid.float()), min=1.0)


def jaccard_from_ids(labels, pred, nb_classes: int):
    """Mean IoU from (B, N) id maps."""
    return jaccard_from_sums(*jaccard_sums_from_ids(labels, pred, nb_classes))
