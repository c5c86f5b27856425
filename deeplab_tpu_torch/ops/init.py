"""Seeded initializers on a ``torch.Generator`` (Keras defaults, as in
deeplab_tpu/ops/init.py).  Shapes are given in the Keras layout (HWIO for
conv kernels) so that the fans follow Keras's convention; the caller permutes
the result into the port's layout.  The numbers differ from ``jax.random``'s
for the same seed: tests hand both packages the same weights instead."""

from __future__ import annotations

import math

import torch


def glorot_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    if len(shape) == 4:  # (kh, kw, in, out)
        receptive = shape[0] * shape[1]
        fan_in, fan_out = shape[2] * receptive, shape[3] * receptive
    else:
        fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (u * (2 * limit) - limit).to(dtype)


def zeros(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype)


def ones(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype)
