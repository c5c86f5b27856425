"""BatchNorm moving-statistics recalibration
(deeplab_tpu/train/bn_calibrate.py).

A net trained from random initialization has moving statistics far from its
batch statistics for thousands of steps (MobileNetV2's BN momentum is
0.999), so its eval-mode output is noise while its training metrics are
fine.  ``calibrate_bn`` re-estimates each BN layer's moving mean and
variance as the mean, over the given batches, of its batch mean and biased
variance: forwards with batch-statistic BN, no dropout and no parameter
update.  Frozen layers keep theirs.

Which path the statistics take: under every policy the plain layer
composition's.  The calibrating net (``SegNet.calibrating``) is in training
mode, so no eval-mode kernel runs (``fused_mbconv``, ``fused_dw``,
``fused_sepconv``), and the training block's gate excludes calibration, so
F1's sums are not used either: each BN takes the mean and biased variance
of its input in float32 (``ops/bn.py``), as the JAX package's calibration
does (its fused gates exclude ``bn_calibrate``).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplab_tpu_torch.ops.bn import BatchNorm, moving_statistics


def calibrate_bn(net, batches, frozen: frozenset = frozenset(),
                 compute_dtype=None):
    """Set ``net``'s BN moving statistics to the mean of the batch
    statistics over ``batches``, in place; returns ``net``.

    Args:
      net: a ``SegNet``; it runs on the device its parameters are on.
      batches: iterable of images (B, H, W, 3), raw 0-255 BGR, e.g.
        ``(X for X, _, _ in generator)``.
      frozen: layer names whose statistics stay as they are (the
        fine-tune freeze set), besides layers already ``frozen``.
      compute_dtype: the forward's policy (default float32).
    """
    dev = next(net.parameters()).device
    policy = compute_dtype or torch.float32
    bns = {name: m for name, m in net.named_children()
           if isinstance(m, BatchNorm)}
    hold = [m for name, m in bns.items() if name in frozen and not m.frozen]
    live = [m for name, m in bns.items() if name not in frozen
            and not m.frozen]
    for m in hold:
        m.frozen = True          # normalize with the moving statistics
    for m in live:
        m.collected = None
    was = net.training
    net.train()
    net.calibrating = True
    n = 0
    try:
        with torch.no_grad(), moving_statistics(net, "collect"):
            for X in batches:
                x = torch.as_tensor(np.asarray(X, np.float32)).to(dev)
                net.apply_logits(x, policy)
                n += 1
    finally:
        net.calibrating = False
        net.train(was)
        for m in hold:
            m.frozen = False
    if n:
        with torch.no_grad():
            for m in live:
                s_mean, s_var, k = m.collected
                m.moving_mean.copy_(s_mean / k)
                m.moving_variance.copy_(s_var / k)
    for m in live:
        m.collected = None
    return net
