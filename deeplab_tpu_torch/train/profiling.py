"""Profiler traces and program spans (deeplab_tpu/train/profiling.py),
over ``torch.profiler``.

- ``trace``: a ``torch.profiler`` trace of a block, CPU and (where there is
  one) CUDA activity, written as a Chrome trace into a directory.
- ``annotate`` (``core.annotate``, re-exported): a named span inside a
  trace, which ``tools/trace.py`` buckets device time by.  With no profiler
  running it is a shared no-op context, so a labelled forward computes and
  records nothing more than an unlabelled one.  The spans:

  - the JAX package's ``jax.named_scope`` labels: ``stem``,
    ``mb{id:02d}s{stride}``, ``aspp``, ``head``, the Xception flow's
    (``xstem``, ``xentry*``, ``xmid*``, ``xexit*``), ``loss``,
    ``optimizer``, ``step_metrics``;
  - the port's layer boundaries, named with ``.`` and never ``/`` (a trace
    reader's scope separator), none holding a label above:
    ``predict`` (one ``Predictor`` call) with ``predict.copy_in``,
    ``predict.model``, ``predict.crf`` and ``predict.copy_out``;
    ``crf.norm`` and, each mean-field iteration, ``crf.blur``,
    ``crf.splat`` and ``crf.step``; ``train_step`` with ``train.put``,
    ``train.forward``, ``loss``, ``train.backward``, ``optimizer`` and
    ``step_metrics``; ``prefetch.wait`` (the step loop's wait for a
    batch).  Each is read by a per-layer metric of ``portbench/metrics``.
- ``StepWindowProfiler``: the trace of train steps ``[start, stop)``, wired
  into ``Trainer.fit`` by ``Trainer(profile_dir=...)``.  The window's edges
  synchronize the device, so no step outside it leaks into the trace;
  between them the steps stay asynchronous.

A profiler records the spans of the thread that started it (and of the
autograd engine's threads), so every span opens on the calling thread.
"""

from __future__ import annotations

import contextlib
import os

import torch

from deeplab_tpu_torch.core import annotate  # noqa: F401  (the spans)


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
