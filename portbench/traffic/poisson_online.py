"""Open loop of single images at a fixed offered rate into the port's
batching dispatcher (``serve.py``: ``BatchingServer(pipeline, size,
max_batch, max_wait_ms).dispatcher.submit``), in process, as independent
users each sending one image.  HTTP and image decoding are left out.

Arrivals: ``rate * seconds`` requests whose gaps are the quantiles of the
exponential distribution at ``rate`` (the same set of gaps for every
seed), in the seed's order: Poisson-like arrivals with a fixed amount of
work.  A pool of threads (``clients``) submits each request when it is
due, so the generator never waits for the server; a request's latency
runs from when it was due to when its mask is back.  The server's pipeline
is the ``Predictor`` wrapped by the benchmark, which times each device call
and counts them.

Parameters: ``rate`` (requests/s), ``max_batch``, ``max_wait_ms``,
``crf``, ``return_raw``, ``pool_images``, ``clients``,
``sample_requests`` (compared with the reference, drawn from the seed,
each sending an image of its own), ``warmup_seconds`` (set-up offers the
same rate that long first), ``trace_seconds`` (the traced tail of
a ``--trace 1`` run; its rates and per-layer numbers come from the part
before it), ``buckets`` (the batch sizes set-up warms).
"""

from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import compare as C
from portbench import harness as H
from portbench import system


def fingerprint(img) -> bytes:
    """A digest of every 8th pixel of an image (its identity among the
    run's images)."""
    return hashlib.blake2b(np.ascontiguousarray(img[::8, ::8]).tobytes(),
                           digest_size=16).digest()


class _Timed:
    """The pipeline the server is given: the Predictor, each call timed
    on the host clock.  A Predictor with ``return_raw`` returns the model's
    labels beside the refined ones: the server gets the refined, and the
    model's labels of the sampled requests' images (found by
    ``fingerprint``) are kept for the comparison."""

    def __init__(self, pred, watch=()):
        self.pred = pred
        self.lock = threading.Lock()
        self.calls = []                    # (end time, ms)
        self.watch = set(watch)
        self.raw = {}

    def __call__(self, imgs):
        t0 = time.perf_counter()
        out = self.pred(imgs)
        t1 = time.perf_counter()
        with self.lock:
            self.calls.append((t1, 1e3 * (t1 - t0)))
        if isinstance(out, tuple):
            raw, out = out
            for i, im in enumerate(imgs):
                fp = fingerprint(im)
                if fp in self.watch:
                    self.raw[fp] = raw[i]
        return out


def arrivals(seed, rate, seconds):
    """Offsets (s) of ``round(rate * seconds)`` arrivals."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(H.rng(seed, "arrivals").permutation(gaps))


def setup(ctx):
    from deeplab_tpu_torch.serve import BatchingServer
    cfg, wl = ctx.config, ctx.workload
    w = H.make_weights(cfg, ctx.seed, ctx.device, size=ctx.size)
    net = system.build_net(cfg, w, ctx.device, ctx.size)
    pred = system.predictor(cfg, wl, net, ctx.device)
    X = H.images(H.rng(ctx.seed, "traffic"),
                 wl["pool_images"] + wl["sample_requests"], ctx.size,
                 ctx.device).cpu().numpy()
    pool, extra = X[:wl["pool_images"]], X[wl["pool_images"]:]
    for b in wl["buckets"]:
        pred(np.concatenate([pool] * -(-b // len(pool)))[:b])
    H.sync(ctx.device)
    timed = _Timed(pred, [fingerprint(im) for im in extra])
    server = BatchingServer(timed, ctx.size, max_batch=wl["max_batch"],
                            max_wait_ms=wl["max_wait_ms"])
    st = {"w": w, "net": net, "pred": pred, "pool": pool, "extra": extra,
          "timed": timed, "server": server}
    if wl.get("warmup_seconds"):         # the threads and the path, warm
        drive(st, ctx.seed + 1, wl["rate"], wl["warmup_seconds"],
              wl["clients"], set())
        timed.calls.clear()
    return st


def drive(st, seed, rate, seconds, clients, sample, on_time=None):
    """Offer the arrivals; returns (latencies s, completion times,
    failures, sampled {request: mask}, the generator's largest lateness
    s).  ``on_time``
    (offset, callable) runs the callable on the generator's thread once
    the arrivals reach that offset, and again when all have completed."""
    sub = st["server"].dispatcher.submit
    pool, extra = st["pool"], st.get("extra", ())
    offs = arrivals(seed, rate, seconds)
    own = {k: j for j, k in enumerate(sorted(sample))}
    lat = np.full(len(offs), np.nan)
    done = np.full(len(offs), np.inf)
    kept, failed = {}, []

    def client(k, due):
        try:
            mask = sub(extra[own[k]] if k in own else pool[k % len(pool)])
        except Exception as e:           # a refused or failed request
            failed.append((k, repr(e)))
            return
        done[k] = time.perf_counter()
        lat[k] = done[k] - due
        if k in sample:
            kept[k] = mask

    late, fired = 0.0, False
    with ThreadPoolExecutor(max_workers=clients) as ex:
        ready = threading.Barrier(clients + 1, timeout=60)
        starters = [ex.submit(ready.wait) for _ in range(clients)]
        ready.wait()                     # every client thread has started
        for f in starters:
            f.result()
        futs = []
        t0 = time.perf_counter() + 0.01
        for k, off in enumerate(offs):
            if on_time is not None and not fired and off >= on_time[0]:
                on_time[1]()
                fired = True
            due = t0 + off
            while True:
                now = time.perf_counter()
                if now >= due:
                    break
                time.sleep(min(due - now, 0.002))
            late = max(late, now - due)
            futs.append(ex.submit(client, k, due))
        for f in futs:
            f.result(timeout=120)
    if on_time is not None and fired:
        on_time[1]()
    return lat, done, failed, kept, late


def window(ctx, st, seconds):
    wl = ctx.workload
    n = max(1, int(round(wl["rate"] * seconds)))
    sample = set(H.rng(ctx.seed, "sample").choice(
        n, min(n, wl["sample_requests"]), replace=False).tolist())
    traced = ctx.trace and seconds > wl["trace_seconds"]
    tracer = H.Tracer(ctx.device) if traced else None
    marks = {}

    def toggle():
        if "start" not in marks:
            marks["start"] = time.perf_counter()
            marks["calls"] = len(st["timed"].calls)
            tracer.__enter__()
        else:
            tracer.__exit__(None, None, None)

    t0 = time.perf_counter()
    lat, done, failed, kept, late = drive(
        st, ctx.seed, wl["rate"], seconds, wl["clients"], sample,
        (seconds - wl["trace_seconds"], toggle) if traced else None)
    calls = st["timed"].calls[:marks.get("calls", len(st["timed"].calls))]
    ok = lat[np.isfinite(lat)]
    last = calls[-1][0] if calls else -np.inf
    rec = {"latency_s": ok, "attempted": len(lat), "failed": len(failed),
           "errors": failed[:3], "sampled": kept, "sample": sample,
           "late_s": late,
           "pipeline_calls": len(calls),
           "completed_in_calls": int((done <= last).sum()),
           "call_ms": [c[1] for c in calls], "batch": 1,
           "seconds": time.perf_counter() - t0}
    if traced:
        rec["tracer"] = tracer
    return rec


def end_to_end(rec):
    lat = rec["latency_s"]
    if rec["failed"] or not len(lat):
        return {}
    return {"latency_p95_ms": 1e3 * H.percentile(lat, 95)}


def check(ctx, st, rec, control=None):
    """The sampled requests' masks against the reference's; every request
    has to come back.  With ``control`` (``{"quant": fn}``) the reference
    at that precision takes the program's place."""
    import torch
    st["server"].dispatcher.shutdown()
    cfg, wl = ctx.config, ctx.workload
    raw_by_fp = st["timed"].raw
    for k in ("net", "pred", "timed", "server"):
        st.pop(k, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    keys = sorted(rec["sampled"])
    out = {"failed": float(rec["failed"])}
    if not keys:
        return out
    own = {k: j for j, k in enumerate(sorted(rec["sample"]))}
    imgs = [st["extra"][own[k]] for k in keys]
    X = torch.from_numpy(np.stack(imgs)).to(ctx.device)
    served = np.stack([rec["sampled"][k] for k in keys])
    raw = None
    if wl.get("return_raw"):
        raw = np.stack([raw_by_fp[fingerprint(im)] for im in imgs])
    out.update(C.serve_check(cfg, st["w"], X, served, raw,
                             cfg["crf"] if wl.get("crf") else None,
                             control))
    return out
