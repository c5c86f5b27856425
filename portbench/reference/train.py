"""Plain training steps of DeepLabV3+ in PyTorch, float32, for the
benchmark's comparison of the training cell.

One step, as the reference Keras code compiles it: the training-mode
forward (BN on the batch's statistics, biased variance; dropout 0.1 after
ASPP), the mean pixel cross-entropy of the head logits against the labels
(unit sample weights), the gradients, and Keras Adam (lr 7e-4, eps 1e-8,
legacy decay 1e-6: lr / (1 + decay * step); the bias-corrected update
``lr * m_hat / (sqrt(v_hat) + eps)``).  Dropout keeps a value where
``torch.rand(shape, generator=gen) < 0.9`` on a generator seeded with the
dropout seed the benchmark hands the program, drawn once a step.

This module imports torch and the plain model only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import Graph, layer_specs

TRAINABLE = ("conv", "dw", "bias", "gamma", "beta")


def trainable_names(cfg):
    return [n for n, _, k in layer_specs(cfg) if k in TRAINABLE]


def run_steps(cfg, w0, batches, dropout_seed: int, lr=7e-4, decay=1e-6,
              eps=1e-8, quant=None, fault=None):
    """Train from ``w0`` over ``batches`` [(X (B, H, W, 3) f32, Y (B, H, W)
    int64)]; returns (losses, the first step's gradients by leaf, each
    leaf's change after the last step).  ``fault="half_batch"``
    plants a fault for a control run: each step sees only the first half
    of its batch."""
    names = trainable_names(cfg)
    p = {n: w0[n].detach().clone().float() for n in names}
    rest = {k: v for k, v in w0.items() if k not in p}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    dev = next(iter(p.values())).device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)

    def dropout(x):
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 0.9
        return torch.where(keep, x / 0.9, 0.0)

    losses, g_first = [], None
    for t, (X, Y) in enumerate(batches):
        if fault == "half_batch":
            X, Y = X[:len(X) // 2], Y[:len(Y) // 2]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        leaves = {n: p[n].requires_grad_(True) for n in names}
        logits = Graph(cfg, {**rest, **leaves}, "train", quant,
                       dropout).logits(X)
        loss = F.cross_entropy(logits, Y)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(float(loss.detach()))
        if t == 0:
            g_first = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr_t = lr / (1.0 + decay * t)
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(0.9).add_(g, alpha=0.1)
                v[n].mul_(0.999).addcmul_(g, g, value=0.001)
                m_hat = m[n] / (1.0 - 0.9 ** (t + 1))
                v_hat = v[n] / (1.0 - 0.999 ** (t + 1))
                p[n] = (p[n].detach() - lr_t * m_hat
                        / (v_hat.sqrt() + eps))
        del logits, loss, grads
    deltas = {n: p[n].detach() - w0[n].float() for n in names}
    return losses, g_first, deltas
