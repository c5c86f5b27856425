"""Training steps through ``Trainer.train_step``, fed by the port's
``Prefetcher`` (one thread) from a seeded pool of prebuilt host batches,
cycled, with no augmentation; no synchronise a step, as ``Trainer.fit``
runs them.

Set-up builds one ``Trainer`` (``compute_dtype`` of the workload,
``setup(net)``), drives it through its first ``compare_steps`` steps on
distinct batches through the same call and feed, records their losses,
the first step's gradient norms (``p.grad``, which a step leaves in place
for the optimizer) and each parameter's change over those steps, and
hands that same trainer to the window.  After the window the plain
reference repeats those steps from the same weights, batches and dropout
seed.

Parameters: ``batch``, ``compute_dtype``, ``pool_batches`` (distinct
batches, cycled), ``compare_steps``, ``trace_steps``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import compare as C
from portbench import harness as H
from portbench import system


class _Cycle:
    """A generator over the pool: ``len`` and ``[]``, as ``Prefetcher``
    asks."""

    def __init__(self, batches, n):
        self.batches, self.n = batches, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.batches[i % len(self.batches)]


def setup(ctx):
    import torch
    from deeplab_tpu_torch.data.generator import Prefetcher
    from deeplab_tpu_torch.train import Trainer
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    B, (Hh, Ww) = wl["batch"], ctx.size
    w = H.make_weights(cfg, ctx.seed, dev, size=ctx.size)
    net = system.build_net(cfg, w, dev, ctx.size)
    X, Y = H.mosaics(H.rng(ctx.seed, "traffic"), B * wl["pool_batches"],
                     ctx.size, dev)
    Xh, Yh = X.cpu().numpy(), Y.to(torch.int32).cpu().numpy()
    sw = np.ones((B, Hh * Ww), np.float32)
    batches = [(Xh[i * B:(i + 1) * B],
                Yh[i * B:(i + 1) * B].reshape(B, Hh * Ww, 1), sw)
               for i in range(wl["pool_batches"])]
    dropout_seed = H.torch_seed(ctx.seed, "dropout")
    trainer = Trainer(net, compute_dtype=getattr(torch, wl["compute_dtype"]),
                      device=dev, seed=dropout_seed, verbose=0)
    trainer.setup(net)
    pipe = Prefetcher(_Cycle(batches, 1 << 30))
    it = iter(pipe)
    losses, grads = [], None
    for s in range(wl["compare_steps"]):
        m = trainer.train_step(*next(it))
        losses.append(float(m["loss"]))
        if s == 0:
            grads = {n: p.grad.detach().float().clone() for n, p in
                     net.named_parameters() if p.grad is not None}
    deltas = {n: (p.detach() - w[n]).float()
              for n, p in net.named_parameters()}
    H.sync(dev)
    return {"w": w, "net": net, "trainer": trainer, "pipe": pipe, "it": it,
            "first": (losses, grads, deltas), "dropout_seed": dropout_seed,
            "compare": [(X[i * B:(i + 1) * B], Y[i * B:(i + 1) * B])
                        for i in range(wl["compare_steps"])]}


def _steps(st, seconds=None, count=None):
    trainer, it = st["trainer"], st["it"]
    waits, n, t0 = [], 0, time.perf_counter()
    while True:
        tw = time.perf_counter()
        batch = next(it)
        waits.append(1e3 * (time.perf_counter() - tw))
        trainer.train_step(*batch)
        n += 1
        if count is not None and n >= count:
            break
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
    return n, waits


def window(ctx, st, seconds):
    import torch
    wl, dev = ctx.workload, ctx.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n, waits = _steps(st, seconds=seconds)
    H.sync(dev)
    t = time.perf_counter() - t0
    B = wl["batch"]
    rec = {"steps": n, "images": n * B, "seconds": t, "batch": B,
           "batch_wait_ms": waits, "attempted": n * B,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if ctx.trace:
        with H.Tracer(dev) as tr:
            n2, _ = _steps(st, count=wl["trace_steps"])
        rec["trace_steps"] = n2
        rec["tracer"] = tr
    return rec


def end_to_end(rec):
    return {"train_img_s": rec["images"] / rec["seconds"],
            "train_peak_gib": rec["peak_bytes"] / 2 ** 30}


def check(ctx, st, rec, control=None):
    """The reference's steps from the same weights and batches.  With
    ``control`` the reference takes the program's place: at the precision
    ``control["quant"]`` rounds to, or with the fault
    ``control["fault"]`` planted."""
    import torch
    from portbench.reference import train as RT
    st["pipe"].close()
    for k in ("it", "pipe", "trainer", "net"):
        st.pop(k, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with H.no_tf32():
        ref = RT.run_steps(ctx.config, st["w"], st["compare"],
                           st["dropout_seed"])
        prog = st["first"]
        if control is not None:
            prog = RT.run_steps(ctx.config, st["w"], st["compare"],
                                st["dropout_seed"],
                                quant=control.get("quant"),
                                fault=control.get("fault"))
    return C.train_numbers(prog, ref)
