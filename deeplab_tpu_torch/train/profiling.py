"""Step timing and profiler traces (deeplab_tpu/train/profiling.py), over
``torch.profiler``.

- ``StepTimer``: a rolling window of step wall times and items per second
  (the time to dispatch a step: device steps run asynchronously, so the
  window's aggregate rate is the true one).
- ``trace``: a ``torch.profiler`` trace of a block, CPU and (where there is
  one) CUDA activity, written as a Chrome trace into a directory.
- ``annotate``: a named region inside a trace (the JAX package's
  ``jax.named_scope`` labels: ``stem``, ``mb{id:02d}s{stride}``, ``aspp``,
  ``head``, the Xception flow's, ``loss``, ``optimizer``,
  ``step_metrics``), which ``tools/trace.py`` buckets device time by.
  With no profiler running it is a shared no-op context, so a labelled
  forward computes and records nothing more than an unlabelled one.
- ``StepWindowProfiler``: the trace of train steps ``[start, stop)``, wired
  into ``Trainer.fit`` by ``Trainer(profile_dir=...)``.  The window's edges
  synchronize the device, so no step outside it leaks into the trace;
  between them the steps stay asynchronous.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Optional

import torch


class StepTimer:
    """Rolling window of step wall times with throughput accounting."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1):
        assert self._t0 is not None
        self.times.append((time.perf_counter() - self._t0, items))
        self._t0 = None

    @property
    def mean_step_s(self) -> float:
        if not self.times:
            return 0.0
        return sum(t for t, _ in self.times) / len(self.times)

    @property
    def items_per_s(self) -> float:
        total_t = sum(t for t, _ in self.times)
        total_i = sum(i for _, i in self.times)
        return total_i / total_t if total_t else 0.0

    def summary(self) -> str:
        return (f"{self.mean_step_s * 1e3:.1f} ms/step, "
                f"{self.items_per_s:.1f} items/s")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync():
    """Drain the card's queue, where this process has used the card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _write(prof, logdir: str, name: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block with ``torch.profiler`` and write
    ``{logdir}/trace.pt.trace.json`` (Chrome / Perfetto); the card's queue
    is drained at both ends."""
    prof = torch.profiler.profile(activities=_activities())
    _sync()
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        _write(prof, logdir, "trace")


_NO_REGION = contextlib.nullcontext()


def annotate(name: str):
    """Named region inside a trace: a ``record_function`` range while a
    profiler runs, else a shared no-op context (no ``record_function`` is
    created); also while a graph is traced or exported, so a program holds
    no profiler operator."""
    if (not torch.autograd.profiler._is_profiler_enabled
            or torch.compiler.is_compiling()):
        return _NO_REGION
    return torch.profiler.record_function(name)


class StepWindowProfiler:
    """Trace train steps ``[start, stop)`` into ``logdir``
    (``steps_{start}_{stop}.pt.trace.json``).  ``before_step`` and
    ``after_step`` take the global step; the window's edges drain the
    card's queue.  ``path`` is the trace written, once the window closed."""

    def __init__(self, logdir: str, start: int = 2, stop: int = 5):
        if stop <= start:
            raise ValueError(f"profile window [{start}, {stop}) is empty")
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self.active = False
        self.done = False
        self.path = None
        self._prof = None

    def before_step(self, step: int):
        """Call before dispatching ``step``; opens the window at
        ``start``, on a drained queue."""
        if self.done or self.active or step != self.start:
            return
        _sync()
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.start()
        self.active = True

    def after_step(self, step: int):
        """Call after dispatching ``step``; closes the window after
        ``stop - 1``, once the device has finished it."""
        if not self.active or step != self.stop - 1:
            return
        self._finish()

    def _finish(self):
        _sync()
        self._prof.stop()
        self.active = False
        self.done = True
        self.path = _write(self._prof, self.logdir,
                           f"steps_{self.start}_{self.stop}")
        self._prof = None

    def close(self):
        """Stop a window that never reached its end (a short fit, an
        exception inside it) and write what it traced."""
        if self.active:
            self._finish()
