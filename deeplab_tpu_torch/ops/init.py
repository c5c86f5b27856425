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


def glorot_normal(gen: torch.Generator, shape, dtype=torch.float32):
    if len(shape) == 4:
        receptive = shape[0] * shape[1]
        fan_in, fan_out = shape[2] * receptive, shape[3] * receptive
    else:
        fan_in, fan_out = shape[0], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return (torch.randn(tuple(shape), generator=gen) * std).to(dtype)


def icnr(gen: torch.Generator, shape, r: int, base_init=glorot_normal,
         dtype=torch.float32):
    """ICNR init of a (kh, kw, in, out) kernel feeding ``phase_shift(r)``:
    one sub-kernel of ``out / r^2`` filters, replicated so that the r^2
    output channels of each filter start identical.  Channel order
    ``f*r^2 + dc*r + dr`` (ops/pixel_shuffle.py); since the copies are
    identical the order only fixes where they go."""
    kh, kw, cin, cout = shape
    if r == 1:
        return base_init(gen, shape, dtype)
    f = cout // (r * r)
    if f * r * r != cout:
        raise ValueError(f"out channels {cout} not divisible by r^2={r * r}")
    sub = base_init(gen, (kh, kw, cin, f), dtype)
    return sub[..., None].expand(kh, kw, cin, f, r * r).reshape(shape)


def zeros(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype)


def ones(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype)
