"""Losses with the reference's void-masking semantics (deeplab_tpu/losses.py).

Labels are in [0, n_classes], where ``n_classes`` is the void label: void
pixels contribute exactly zero cross-entropy.  Per-pixel "temporal" sample
weights reduce as ``sum(loss * sw) / count_nonzero(sw)`` (Keras
weighted-objective semantics).  The Trainer uses the fused log-softmax form
on the head logits.
"""

from __future__ import annotations

import torch


def sparse_logits_crossentropy_ignoring_last_label(y_true, logits):
    """Per-pixel CE from logits through a log-softmax in f32.  ``y_true``:
    (...) or (..., 1) labels; ``logits``: (..., C) in any float dtype."""
    nb_classes = logits.shape[-1]
    labels = y_true.long()
    if labels.dim() == logits.dim():
        labels = labels[..., 0]
    z = logits.float()
    lse = torch.logsumexp(z, dim=-1)
    z_label = torch.gather(z, -1, labels.clamp(0, nb_classes - 1)[..., None])
    return torch.where(labels >= nb_classes, 0.0, lse - z_label[..., 0])


def weighted_loss(per_px_loss, sample_weights):
    """Keras temporal-sample-weight reduction: mean over nonzero-weight
    pixels of (loss * weight)."""
    num = torch.sum(per_px_loss * sample_weights)
    den = torch.sum((sample_weights != 0).to(per_px_loss.dtype))
    return num / torch.clamp(den, min=1.0)


def masked_sparse_ce_logits(y_true, logits, sample_weights=None):
    """CE from logits plus optional temporal weighting in one call."""
    loss = sparse_logits_crossentropy_ignoring_last_label(y_true, logits)
    if sample_weights is None:
        return torch.mean(loss)
    return weighted_loss(loss, sample_weights)
