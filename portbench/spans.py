"""The program's spans and the device's ops of a traced run, on one clock.

A traced run keeps its ``torch.profiler`` object (``run.trace.prof``).
Every event of it has an absolute start and end in ns on the host's Unix
clock (``prof.profiler.kineto_results.events()``; the Chrome trace's ``ts``
plus its ``baseTimeNanoseconds``): the program's spans, ``record_function``
ranges of ``deeplab_tpu_torch/train/profiling.py::annotate`` (user
annotations), with the thread that opened them; and the device's ops
(kernels, copies and sets: the ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events of the Chrome trace).  So a stretch in which the
device ran nothing can be laid against what the host was inside.

- The program's spans are the user annotations with lower-case dotted
  names (``predict.copy_in``, ``train_step``, ``mb03s1``); torch's own
  ranges (``Optimizer.step#Adam.step``, ``ProfilerStep#2``) are not.
- Idle time is the complement of the union of device op intervals between
  the first device op's start and the last one's end (the definition of
  ``device_idle_share``).
- The calling thread is the thread on which the root spans (``predict``,
  ``train_step``) open; each idle ns is charged to the innermost program
  span open on it then, or to none (``idle_share``), or counted while a
  given span is open at any depth (``idle_share_within``).
- A device op's scope is the chain of spans it was launched in, as
  ``portbench/trace.py`` gives it (``scope_ms_per_call``).

A profiler without these events, or a program without the spans (a run of
an older checkout), gives None, never an error.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict

from portbench import readers as R

PROGRAM_SPAN = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)*$")
ROOTS = ("predict", "train_step")


class Timeline:
    """``spans``: [(thread, start_ns, end_ns, name)] of the program's
    spans; ``device``: [(start_ns, end_ns)] of the device's ops."""

    def __init__(self, spans, device):
        self.spans = sorted(spans, key=lambda s: (s[0], s[1], -s[2]))
        self.device = sorted(device)

    def busy_ns(self) -> int:
        return sum(b - a for a, b in union(self.device))

    def idle(self):
        """[(start_ns, end_ns)] of the stretches with no device op."""
        merged = union(self.device)
        return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]

    def calling_thread(self, roots=ROOTS):
        """The thread that opened most root spans, or None."""
        n = Counter(t for t, _, _, name in self.spans if name in roots)
        return n.most_common(1)[0][0] if n else None

    def of_thread(self, thread, name=None):
        return [s for s in self.spans
                if s[0] == thread and (name is None or s[3] == name)]

    def idle_by_span(self, thread):
        """{innermost span name, or None: idle ns} on ``thread``."""
        segs = innermost([s[1:] for s in self.of_thread(thread)])
        out = defaultdict(int)
        i = 0
        for a, b in self.idle():
            covered = 0
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < b:
                lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
                if hi > lo:
                    out[segs[j][2]] += hi - lo
                    covered += hi - lo
                j += 1
            out[None] += (b - a) - covered
        return dict(out)

    def idle_within(self, thread, name) -> int:
        """Idle ns while a span ``name`` is open on ``thread``, at any
        depth."""
        inside = union((s, e) for _, s, e, _ in self.of_thread(thread, name))
        return overlap(self.idle(), inside)


def union(intervals):
    """The merged, sorted union of ``[(start, end)]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def overlap(a, b) -> int:
    """The length of the intersection of two sorted lists of disjoint
    ``(start, end)`` intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans):
    """[(start, end, name)] of one thread's nested spans ->
    non-overlapping sorted segments, each under the innermost span open
    there; stretches inside no span are left out."""
    out, stack, cur = [], [], None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            emit(cur, end, inner)
            cur = end
        if stack:
            emit(cur, s, stack[-1][1])
            e = min(e, stack[-1][0])
        cur = s
        stack.append((e, name))
    while stack:
        end, inner = stack.pop()
        emit(cur, end, inner)
        cur = end
    return out


def _on_device(e) -> bool:
    kind = e.device_type()
    return getattr(kind, "name", str(kind)) != "CPU"


def from_events(events) -> Timeline:
    """A :class:`Timeline` from a profiler's Kineto events.  A device op
    is an event on the device that is not an annotation (the profiler
    mirrors each host annotation on the device's timeline); a span, a
    program's annotation on the host."""
    spans, device = [], []
    for e in events:
        user = e.is_user_annotation()
        if _on_device(e):
            if not user:
                device.append((e.start_ns(), e.end_ns()))
        elif user and PROGRAM_SPAN.match(e.name()):
            spans.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                          e.name()))
    return Timeline(spans, device)


def timeline(run):
    """The traced run's :class:`Timeline` (read once a run), or None."""
    tr = run.trace
    if tr is None:
        return None
    if not hasattr(tr, "program_timeline"):
        try:
            events = tr.prof.profiler.kineto_results.events()
        except AttributeError:             # no such events: no reading
            events = None
        tr.program_timeline = (None if events is None
                               else from_events(events))
    return tr.program_timeline


def mean_span_ms(run, name):
    """Mean host ms of the span ``name`` on the calling thread, or None."""
    tl = timeline(run)
    if tl is None:
        return None
    th = tl.calling_thread()
    spans = tl.of_thread(th, name) if th is not None else []
    if not spans:
        return None
    return sum(e - s for _, s, e, _ in spans) / len(spans) / 1e6


def _calling(run):
    """(timeline, calling thread) of a run with device ops, or None."""
    tl = timeline(run)
    if tl is None or not tl.device:
        return None
    th = tl.calling_thread()
    return None if th is None else (tl, th)


def idle_share(run, names):
    """% of the device's idle time in which the calling thread's innermost
    span is one of ``names``; None without device ops or spans."""
    got = _calling(run)
    if got is None:
        return None
    by = got[0].idle_by_span(got[1])
    total = sum(by.values())
    if total <= 0:
        return None
    return 100.0 * sum(by.get(n, 0) for n in names) / total


def idle_share_within(run, name):
    """% of the device's idle time during which the span ``name`` is open
    on the calling thread, at any depth (the spans inside it included);
    None without device ops or such a span."""
    got = _calling(run)
    if got is None or not got[0].of_thread(got[1], name):
        return None
    tl, th = got
    total = sum(b - a for a, b in tl.idle())
    if total <= 0:
        return None
    return 100.0 * tl.idle_within(th, name) / total


def scope_us(trace, label) -> float:
    """Device µs of the traced ops launched inside the span ``label`` (it
    is in their scope)."""
    return sum(dur for _, scope, dur, _ in trace.ops
               if label in R.labels(scope)[0])


def scope_ms_per_call(run, label):
    """Device ms a traced call of the ops launched inside the span
    ``label``, or None without such ops."""
    tr = run.trace
    if tr is None or not tr.on_device:
        return None
    us = scope_us(tr, label)
    calls = R.calls_traced(run)
    if us <= 0 or calls <= 0:
        return None
    return us / calls / 1e3
