"""Helpers of the per-layer readers (``metrics/<name>.py``): regions of
the traced device ops, and the work they are held against.

A device op's scope is its enclosing trace labels joined by ``/``, inside
``bwd(...)`` where the backward launched it (``portbench/trace.py``).
"""

from __future__ import annotations

import re

from portbench.work import crf as WC
from portbench.work import deeplabv3p as WD
from portbench.work.peaks import PEAK_FLOP_S, bound_s

MB_S1 = re.compile(r"^mb\d\ds1$")
XCEPTION_BLOCK = re.compile(r"^(xentry\d|xmid\d\d|xexit\d)$")
MODEL_LABELS = re.compile(r"^(stem|mb\d\ds\d|aspp|head|xstem|xentry\d|"
                          r"xmid\d\d|xexit\d)$")


def labels(scope: str):
    """(labels of a scope, whether it is a backward scope)."""
    bwd = scope.startswith("bwd(") and scope.endswith(")")
    inner = scope[4:-1] if bwd else scope
    return [s for s in inner.split("/") if s], bwd


def region_us(ops, pattern, backward=None):
    """Device µs of the ops under a label matching ``pattern`` (forward,
    backward or both)."""
    total = 0.0
    for _, scope, dur, _ in ops:
        labs, bwd = labels(scope)
        if backward is not None and bwd != backward:
            continue
        if any(pattern.match(s) for s in labs):
            total += dur
    return total


def memcpy_us(ops, kinds=("HtoD", "DtoH")):
    return sum(d for name, _, d, _ in ops
               if name.startswith("Memcpy") and any(k in name
                                                    for k in kinds))


def post_model_us(ops):
    """Device µs of the non-copy ops that run after a call's last model
    region: the head, the argmax and what follows them (the CRF), up to
    the next call's input.  Between one call's last labelled op and the
    next call's first, the ops after the last host-to-device copy prepare
    the next call's input and are left out."""
    ops = sorted(ops, key=lambda o: o[3]["ts"])
    marks = [i for i, o in enumerate(ops)
             if any(MODEL_LABELS.match(s) for s in labels(o[1])[0])]
    total = 0.0
    for a, b in zip(marks, marks[1:] + [len(ops)]):
        between = ops[a + 1:b]
        if not between:
            continue
        copies = [i for i, o in enumerate(between)
                  if o[0].startswith("Memcpy") and "HtoD" in o[0]]
        end = copies[-1] if copies and b < len(ops) else len(between)
        total += sum(o[2] for o in between[:end]
                     if not o[0].startswith(("Memcpy", "Memset")))
    return total


def calls_traced(run):
    rec = run.records
    return rec.get("trace_images", 0) / rec["batch"]


def roofline(run, pattern, backward=False):
    """Bound of the work under the labels matching ``pattern`` over their
    device time in the traced window, in %; None without such time."""
    tr = run.trace
    if tr is None or not tr.on_device:
        return None
    us = region_us(tr.ops, pattern, None if backward else False)
    if us <= 0:
        return None
    H, W = run.size
    B = run.records["batch"]
    n = (run.records["trace_steps"] if backward else calls_traced(run))
    work = WD.regions(run.config, B, H, W)
    t = 0.0
    for name, w in work.items():
        if pattern.match(name):
            t += bound_s(w.flops, w.bytes)
            if backward:
                b = WD.backward(w)
                t += bound_s(b.flops, b.bytes)
    return 100.0 * t * n / (us / 1e6)


def serve_flops_per_image(run):
    H, W = run.size
    f = WD.model_flops(run.config, H, W)
    if run.workload.get("crf"):
        f += WC.flops(run.config["crf"], 1, H, W, run.config["n_classes"])
    return f


def mfu(flops_per_item, items, seconds):
    return 100.0 * flops_per_item * items / (seconds * PEAK_FLOP_S)


def idle_share(run):
    tr = run.trace
    if tr is None or not tr.on_device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
