"""Optimizer and layer-freeze policy (deeplab_tpu/train/optimizer.py).

Reference compile: ``Adam(lr=7e-4, epsilon=1e-8, decay=1e-6)``.  Keras's
legacy ``decay`` is the per-step schedule ``lr / (1 + decay * step)``.
``torch.optim.Adam`` computes the same bias-corrected update as optax's
``scale_by_adam`` (eps added to the corrected root); :class:`KerasAdam`
sets its learning rate before every step from the schedule times the
Trainer's ``lr_scale`` (ReduceLROnPlateau).  Frozen layers get no gradient
(``requires_grad=False``), so Adam leaves them alone.
"""

from __future__ import annotations

from typing import Optional

import torch


def freeze_set(names, freeze_before: Optional[str] = "concat_projection",
               order=None) -> frozenset:
    """Layer names to freeze: everything before ``freeze_before`` in graph
    order (``order``, e.g. ``SegNet.layer_order``; else ``names`` in their
    own order).  ``freeze_before=None`` freezes nothing."""
    if freeze_before is None:
        return frozenset()
    names = list(order) if order is not None else list(names)
    if freeze_before not in names:
        raise ValueError(
            f"freeze_before layer {freeze_before!r} not found in the model "
            f"(known layers include e.g. {names[:3]}...)")
    return frozenset(names[:names.index(freeze_before)])


def keras_adam_schedule(lr: float = 7e-4, decay: float = 1e-6):
    def schedule(step):
        return lr / (1.0 + decay * step)
    return schedule


class KerasAdam:
    """Keras Adam with the legacy decay schedule over ``params``."""

    def __init__(self, params, lr: float = 7e-4, epsilon: float = 1e-8,
                 decay: float = 1e-6):
        self.schedule = keras_adam_schedule(lr, decay)
        self.count = 0
        self.opt = torch.optim.Adam(list(params), lr=lr, betas=(0.9, 0.999),
                                    eps=epsilon)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self, lr_scale: float = 1.0):
        lr = self.schedule(self.count) * lr_scale
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
