"""Read ``torch.profiler`` Chrome traces into per-op and per-region tables
(the port's counterpart of the JAX repo's ``tools/xplane.py``).

``train/profiling.py`` writes ``*.pt.trace.json`` files (``trace``,
``StepWindowProfiler``, ``Trainer(profile_dir=...)``); the models and the
Trainer label their regions with ``profiling.annotate``, the names of the
JAX package's ``jax.named_scope`` labels.  Each device op of a trace (a
``kernel``, ``gpu_memcpy`` or ``gpu_memset`` event) is attributed in three
steps:

1. launch: its ``correlation`` id names the launch event (category
   ``LAUNCH_CATS``), on some host thread at some time;
2. forward region: the ``user_annotation`` ranges on that thread that
   enclose the launch, outermost first, joined by ``/`` (the scope, as a
   JAX ``op_name`` joins its name stack);
3. backward region: a launch inside ``autograd::engine::evaluate_function:
   XBackward`` takes the scope of the forward op with the same ``Sequence
   number`` (the op that made the node: the latest forward op with that
   number), as ``bwd(<scope>)``, as JAX marks ``transpose(...)``.

A trace with no device activity (a CPU run) has its leaf CPU ops (those
enclosing no other CPU op on their thread) stand in for the device ops,
with their durations, so the same attribution runs without a card.

Typical use (``tools/profile_train.py``)::

    ops = device_ops(load(newest_trace("prof")))    # [(name, scope, us, info)]
    totals, tops = bucket(ops, RULES)               # region -> ms
    print_table(totals)
"""

from __future__ import annotations

import bisect
import glob
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function:"


def newest_trace(logdir: str) -> str:
    """Newest ``*.pt.trace.json`` under ``logdir`` (searched
    recursively)."""
    hits = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                     recursive=True)
    if not hits:
        raise FileNotFoundError(f"no .pt.trace.json under {logdir}")
    return max(hits, key=os.path.getmtime)


def load(path: str) -> list:
    """The complete (``ph == "X"``) events of a Chrome trace."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"]


class _Thread:
    """The host ranges of one thread, nested, for point and range
    queries."""

    def __init__(self, events):
        # outer before inner where two start together
        self.events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.events]
        self.parent = []          # index of the enclosing range, or -1
        self.leaf = []            # a CPU op enclosing no other CPU op
        stack = []
        for i, e in enumerate(self.events):
            while stack and self._end(stack[-1]) <= e["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            self.leaf.append(e.get("cat") == "cpu_op")
            if e.get("cat") == "cpu_op":
                for j in reversed(stack):
                    if self.events[j].get("cat") == "cpu_op":
                        self.leaf[j] = False
                        break
            stack.append(i)

    def _end(self, i):
        e = self.events[i]
        return e["ts"] + e["dur"]

    def enclosing(self, ts: float, start: int = None):
        """Indices of the ranges that enclose time ``ts``, innermost
        first (from range ``start`` outwards, where given)."""
        if start is None:
            i = bisect.bisect_right(self.starts, ts) - 1
            while i >= 0 and self._end(i) < ts:
                i = self.parent[i]
        else:
            i = start
        out = []
        while i >= 0:
            out.append(i)
            i = self.parent[i]
        return out


def _seq(e):
    return (e.get("args") or {}).get("Sequence number")


def _attribute(th: _Thread, chain):
    """(scope, backward, seq) of a point whose enclosing ranges are
    ``chain`` (innermost first): the user annotations between the point
    and the innermost backward node, outermost first, and that node's
    sequence number."""
    names, seq, backward = [], None, False
    for i in chain:
        e = th.events[i]
        name = e["name"]
        if name.startswith(BACKWARD):
            backward = True
            seq = _seq(e) if _seq(e) is not None else seq
            break
        if _seq(e) is not None:
            seq = _seq(e)           # the node's own event, inside the engine's
        if e.get("cat") == "user_annotation":
            names.append(name)
    return "/".join(reversed(names)), backward, seq


def device_ops(events):
    """[(name, scope, dur_us, info)] of every device op of a trace (on a
    trace without device activity: every leaf CPU op).  ``scope`` is the
    attributed region path (``bwd(...)`` in the backward, ``""`` where no
    label encloses the launch); ``info`` holds ``backward`` (bool),
    ``launched`` (False where no launch event matched the op's
    correlation id) and ``ts`` (its start)."""
    threads = defaultdict(list)
    launches = {}
    device = []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in ("cpu_op", "user_annotation"):
            threads[(e.get("pid"), e.get("tid"))].append(e)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    th = {k: _Thread(v) for k, v in threads.items()}

    # forward scope of each autograd node: the latest forward op that
    # carries its sequence number (the one that made it)
    fwd_scope = {}
    for t in th.values():
        for i, e in enumerate(t.events):
            s = _seq(e)
            if s is None or e["name"].startswith(BACKWARD):
                continue
            scope, backward, _ = _attribute(t, t.enclosing(None, i))
            if backward:
                continue
            if s not in fwd_scope or fwd_scope[s][0] <= e["ts"]:
                fwd_scope[s] = (e["ts"], scope)

    def resolve(t, chain):
        scope, backward, seq = _attribute(t, chain)
        if backward and not scope:
            inner = fwd_scope.get(seq, (0, ""))[1]
            scope = f"bwd({inner})" if inner else ""
        elif backward:
            scope = f"bwd({scope})"
        return scope, backward

    out = []
    if device:
        for d in device:
            corr = (d.get("args") or {}).get("correlation")
            la = launches.get(corr)
            t = th.get((la.get("pid"), la.get("tid"))) if la else None
            if t is None:
                scope, backward = "", False
            else:
                scope, backward = resolve(t, t.enclosing(la["ts"]))
            out.append((d["name"], scope, float(d.get("dur", 0.0)),
                        {"backward": backward, "launched": la is not None,
                         "ts": d["ts"]}))
        return out
    for t in th.values():
        for i, e in enumerate(t.events):
            if not t.leaf[i]:
                continue
            scope, backward = resolve(t, t.enclosing(None, i))
            out.append((e["name"], scope, float(e.get("dur", 0.0)),
                        {"backward": backward, "launched": True,
                         "ts": e["ts"]}))
    return out


def busy_us(ops) -> float:
    """The union of the ops' intervals (µs): the device's busy time, each
    overlap counted once."""
    spans = sorted((o[3]["ts"], o[3]["ts"] + o[2]) for o in ops)
    total, end = 0.0, None
    start = None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def bucket(ops, rules, default="other"):
    """Aggregate op durations into named regions.

    ``rules``: ordered [(region, predicate(scope))]; the first match wins,
    and an op no rule matches goes to ``default``.  Returns ({region: ms},
    {region: [(op [scope], ms)] sorted by time}).  Every op lands in
    exactly one region, so the regions sum to the ops' total."""
    totals = defaultdict(float)
    members = defaultdict(lambda: defaultdict(float))
    for name, scope, dur_us, _ in ops:
        ms = dur_us / 1e3
        for region, pred in rules:
            if pred(scope):
                break
        else:
            region = default
        totals[region] += ms
        members[region][f"{name} [{scope}]" if scope else name] += ms
    tops = {r: sorted(m.items(), key=lambda kv: -kv[1])
            for r, m in members.items()}
    return dict(totals), tops


def split(ops):
    """(forward-scoped, backward-scoped, unscoped) µs of ``ops``: the
    port's counterpart of JAX's fwd / ``transpose`` / unscoped split."""
    fwd = bwd = none = 0.0
    for _, scope, dur, info in ops:
        if not scope:
            none += dur
        elif info["backward"]:
            bwd += dur
        else:
            fwd += dur
    return fwd, bwd, none


def print_table(totals, total_label="total", file=None):
    """Print ``{region: ms}`` sorted by time with shares; returns the
    total."""
    tot = sum(totals.values())
    width = max((len(k) for k in totals), default=10)
    for k, v in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<{width}}  {v:8.3f} ms  {100 * v / max(tot, 1e-12):5.1f}%",
              file=file)
    print(f"  {total_label:<{width}}  {tot:8.3f} ms", file=file)
    return tot
