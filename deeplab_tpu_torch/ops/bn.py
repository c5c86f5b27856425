"""BatchNormalization with Keras semantics (deeplab_tpu/ops/bn.py).

Per-layer epsilon and momentum: eps 1e-3 and momentum 0.999 in the
MobileNetV2 trunk, eps 1e-5 and the Keras default momentum 0.99 in ASPP.
``gamma`` and ``beta`` are parameters; the moving statistics are buffers.

Eval mode normalizes with the moving statistics.  Training mode normalizes
with the batch mean and biased variance (f32) and updates the moving
statistics as ``moving*momentum + batch*(1 - momentum)``.  A frozen layer
(``frozen = True``, set by the Trainer's freeze policy) normalizes with its
moving statistics and leaves them alone, as Keras does for
``trainable=False``.  The affine is rounded to the activation dtype.

What a training-mode BN does with its batch statistics is its
``moving`` attribute, which :func:`moving_statistics` sets for every BN of
a net: ``"update"`` (the momentum update above, the default), ``"hold"``
(nothing: a rematerialized forward replaying a step must not apply the
momentum twice) or ``"collect"`` (sum them into ``collected`` for
``train/bn_calibrate.py``).  It lives on the modules, not on a thread,
because autograd may replay a forward on its own device thread.  Every
update, the training MBConv block's too, goes through
:meth:`BatchNorm.update_moving`.

A BN whose ``group`` is a data-parallel mesh (``parallel/mesh.py``, set by
the Trainer's SPMD mode over more than one process) normalizes a training
batch with the statistics of the global batch: the sums over every
process's rows, all-reduced under autograd, so the gradient reaches every
process's inputs, as JAX's SPMD step computes BN over its sharded batch.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from deeplab_tpu_torch.ops import init as inits

_MODES = ("update", "hold", "collect")


@contextlib.contextmanager
def moving_statistics(net: nn.Module, mode: str):
    """Within the block, every BN of ``net`` treats its batch statistics as
    ``mode`` says (see the module docstring)."""
    if mode not in _MODES:
        raise ValueError(f"unknown moving-statistics mode {mode!r}")
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    saved = [m.moving for m in bns]
    for m in bns:
        m.moving = mode
    try:
        yield
    finally:
        for m, mode_ in zip(bns, saved):
            m.moving = mode_


class _AllSum(torch.autograd.Function):
    """``t`` summed over the mesh's processes, under autograd: the
    gradient of every process's copy of the sum is summed back the same
    way (each process's loss part depends on every process's inputs)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_sum(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_sum(grad.clone()), None


def bn_scale_shift(bn: "BatchNorm"):
    """Folded eval affine ``(scale, shift)`` in float32."""
    scale = bn.gamma.float() * torch.rsqrt(bn.moving_variance.float() + bn.eps)
    return scale, bn.beta.float() - bn.moving_mean.float() * scale


class BatchNorm(nn.Module):
    frozen = False
    moving = "update"

    def __init__(self, channels: int, eps: float = 1e-3, gen=None,
                 momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.gamma = nn.Parameter(inits.ones(gen, (channels,)))
        self.beta = nn.Parameter(inits.zeros(gen, (channels,)))
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_variance", torch.ones(channels))

    collected = None     # (sum of means, sum of variances, batches)
    group = None         # the mesh whose batch this BN's statistics cover

    def batch_statistics(self, xf: torch.Tensor):
        """(mean, biased variance) per channel of the f32 NCHW ``xf``; over
        the global batch when ``group`` is set (two all-reduces: the sums
        with the count, then the squared deviations from the global
        mean)."""
        dims = (0, 2, 3)
        if self.group is None or self.group.world == 1:
            return xf.mean(dim=dims), xf.var(dim=dims, unbiased=False)
        C = xf.shape[1]
        count = xf.new_full((1,), float(xf.numel() // C))
        sums = _AllSum.apply(torch.cat([xf.sum(dim=dims), count]),
                             self.group)
        mean = sums[:C] / sums[C]
        sq = _AllSum.apply((xf - mean[:, None, None]).square().sum(dim=dims),
                           self.group)
        return mean, sq / sums[C]

    @torch.no_grad()
    def update_moving(self, mean, var):
        if self.moving == "hold":
            return
        if self.moving == "collect":
            s_mean, s_var, n = self.collected or (0.0, 0.0, 0)
            self.collected = (mean.float() + s_mean, var.float() + s_var,
                              n + 1)
            return
        m = self.momentum
        self.moving_mean.copy_(self.moving_mean * m + mean * (1.0 - m))
        self.moving_variance.copy_(self.moving_variance * m + var * (1.0 - m))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW."""
        if self.training and not self.frozen:
            mean, var = self.batch_statistics(x.float())
            self.update_moving(mean.detach(), var.detach())
            scale = self.gamma * torch.rsqrt(var + self.eps)
            shift = self.beta - mean * scale
        else:
            scale, shift = bn_scale_shift(self)
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])
