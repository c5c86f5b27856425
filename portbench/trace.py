"""A frozen copy of the port's trace reader (``tools/trace.py``), so that
the benchmark's arithmetic does not move with the program.

Each device op of a ``torch.profiler`` Chrome trace (a ``kernel``,
``gpu_memcpy`` or ``gpu_memset`` event) is attributed in three steps:

1. launch: its ``correlation`` id names the launch event (category
   ``LAUNCH_CATS``), on some host thread at some time;
2. forward region: the ``user_annotation`` ranges on that thread that
   enclose the launch, outermost first, joined by ``/``;
3. backward region: a launch inside ``autograd::engine::evaluate_function:
   XBackward`` takes the scope of the forward op with the same ``Sequence
   number``, as ``bwd(<scope>)``.

Beyond the original: each op's ``info["host"]`` is the innermost host op
around its launch, and :func:`idle_gaps` lists the device's idle
stretches.  A trace with no device activity (a CPU run) has its leaf CPU
ops stand in for the device ops.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function:"


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
            host = ""
            if t is None:
                scope, backward = "", False
            else:
                chain = t.enclosing(la["ts"])
                scope, backward = resolve(t, chain)
                host = next((t.events[i]["name"] for i in chain
                             if t.events[i].get("cat") == "cpu_op"), "")
            out.append((d["name"], scope, float(d.get("dur", 0.0)),
                        {"backward": backward, "launched": la is not None,
                         "ts": d["ts"], "host": host}))
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


def idle_gaps(ops, events=None):
    """[(label, seconds)] of every stretch in which no device op ran,
    between the first op's start and the last op's end; each labelled by
    the op that ended it and the host op that launched it."""
    spans = sorted(((o[3]["ts"], o[3]["ts"] + o[2], o) for o in ops),
                   key=lambda s: s[0])
    out, end = [], None
    for a, b, o in spans:
        if end is not None and a > end:
            host = o[3].get("host") or "?"
            label = f"{host} -> {o[0][:60]}" + (f" [{o[1]}]" if o[1] else "")
            out.append((label, (a - end) / 1e6))
        end = b if end is None else max(end, b)
    return out
