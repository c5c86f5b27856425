"""Closed loop of batches through ``Predictor.__call__``: one caller sends
its next batch when the previous masks are back, as a bulk or offline user
does.

Parameters (the workload file): ``batch`` (images a call), ``crf``
(``true``: the configuration's CRF), ``return_raw`` (the calls return
the model's labels beside the refined ones), ``pool_batches`` (distinct batches,
cycled), ``warmup_calls``, ``sample_calls`` (calls whose masks are
compared, drawn from the seed), ``trace_seconds`` (the traced sub-window of
a ``--trace 1`` run).  Images are float32 (B, H, W, 3) BGR 0-255 host
arrays, as a decoder hands them over.
"""

from __future__ import annotations

import time

from portbench import compare as C
from portbench import harness as H
from portbench import system


def setup(ctx):
    cfg, wl = ctx.config, ctx.workload
    B, size = wl["batch"], ctx.size
    w = H.make_weights(cfg, ctx.seed, ctx.device, size=size)
    net = system.build_net(cfg, w, ctx.device, size)
    pred = system.predictor(cfg, wl, net, ctx.device)
    X = H.images(H.rng(ctx.seed, "traffic"), B * wl["pool_batches"], size,
                 ctx.device).cpu().numpy()
    pool = [X[i * B:(i + 1) * B] for i in range(wl["pool_batches"])]
    for i in range(wl["warmup_calls"]):
        pred(pool[i % len(pool)])
    H.sync(ctx.device)
    return {"w": w, "net": net, "pred": pred, "pool": pool}


def _loop(st, seconds, sampler, start_call):
    pred, pool = st["pred"], st["pool"]
    calls, t0 = start_call, time.perf_counter()
    while True:
        out = pred(pool[calls % len(pool)])
        sampler(calls, out)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return calls - start_call, time.perf_counter() - t0


def window(ctx, st, seconds):
    wl = ctx.workload
    B = wl["batch"]
    r = H.rng(ctx.seed, "sample")
    kept = []

    def sampler(i, out):                 # a reservoir over the calls
        k = wl["sample_calls"]
        if len(kept) < k:
            kept.append((i, out))
        else:
            j = int(r.integers(0, i + 1))
            if j < k:
                kept[j] = (i, out)

    traced = ctx.trace and seconds > wl["trace_seconds"]
    n, t = _loop(st, seconds - (wl["trace_seconds"] if traced else 0.0),
                 sampler, 0)
    rec = {"calls": n, "images": n * B, "seconds": t, "batch": B,
           "sampled": kept}
    if traced:
        with H.Tracer(ctx.device) as tr:
            n2, _ = _loop(st, wl["trace_seconds"], sampler, n)
        rec["trace_images"] = n2 * B
        rec["tracer"] = tr
    return rec


def end_to_end(rec):
    return {"serve_img_s": rec["images"] / rec["seconds"]}


def check(ctx, st, rec, control=None):
    """Compare the sampled calls' labels with the reference's.  With
    ``control`` (``{"quant": fn}``) the reference at that precision takes
    the program's place."""
    import numpy as np
    import torch
    cfg, wl = ctx.config, ctx.workload
    w, pool = st["w"], st["pool"]
    for k in ("net", "pred"):
        st.pop(k, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    X = torch.cat([torch.from_numpy(pool[i % len(pool)])
                   for i, _ in rec["sampled"]]).to(ctx.device)
    outs = [out for _, out in rec["sampled"]]
    raw = None
    if wl.get("return_raw"):
        raw = np.concatenate([o[0] for o in outs])
        outs = [o[1] for o in outs]
    return C.serve_check(cfg, w, X, np.concatenate(outs), raw,
                         cfg["crf"] if wl.get("crf") else None, control)
