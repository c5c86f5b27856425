"""The span arithmetic (``portbench/spans.py``) on hand-built timelines, the
span readers on hand-built events and scopes, and on a traced CPU run."""

import argparse
import types

import pytest
import torch

from portbench import harness as H
from portbench import run as RUN
from portbench import spans as S


def test_union_and_idle():
    tl = S.Timeline([], [(10, 20), (15, 30), (40, 50), (50, 55), (70, 80)])
    assert S.union(tl.device) == [(10, 30), (40, 55), (70, 80)]
    assert tl.busy_ns() == 20 + 15 + 10
    assert tl.idle() == [(30, 40), (55, 70)]
    assert S.Timeline([], []).idle() == []


def test_innermost_segments():
    spans = [(0, 100, "predict"), (0, 30, "predict.copy_in"),
             (40, 80, "predict.crf"), (45, 50, "crf.blur"),
             (50, 60, "crf.splat"), (120, 130, "predict")]
    assert S.innermost(spans) == [
        (0, 30, "predict.copy_in"), (30, 40, "predict"),
        (40, 45, "predict.crf"), (45, 50, "crf.blur"),
        (50, 60, "crf.splat"), (60, 80, "predict.crf"),
        (80, 100, "predict"), (120, 130, "predict")]
    assert S.innermost([]) == []


def test_idle_by_span_and_thread_choice():
    """Two threads: the calling one (two ``train_step`` roots) and a loader
    whose span covers every gap but is not charged; one gap partly inside
    no span."""
    spans = [(1, 0, 100, "train_step"), (1, 0, 20, "train.put"),
             (1, 60, 90, "optimizer"), (1, 150, 200, "train_step"),
             (2, 0, 300, "other.span"), (2, 0, 1, "train_step")]
    device = [(10, 15), (30, 65), (80, 85), (95, 160), (170, 180)]
    tl = S.Timeline(spans, device)
    assert tl.calling_thread() == 1
    assert tl.idle() == [(15, 30), (65, 80), (85, 95), (160, 170)]
    by = tl.idle_by_span(1)
    assert by == {"train.put": 5, "train_step": 10 + 5 + 10,
                  "optimizer": 15 + 5, None: 0}
    assert sum(by.values()) == sum(b - a for a, b in tl.idle())
    by2 = tl.idle_by_span(2)
    assert by2 == {"other.span": 50, None: 0}
    gap = S.Timeline([(1, 0, 10, "predict")], [(0, 5), (20, 30)])
    assert gap.idle_by_span(1) == {"predict": 5, None: 10}


def test_overlap_and_idle_within():
    """Idle time while a span is open at any depth: the spans inside it
    count, the same span on another thread does not."""
    assert S.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert S.overlap([(0, 10)], [(10, 20)]) == 0
    assert S.overlap([], [(0, 5)]) == 0
    spans = [(1, 0, 100, "train_step"), (1, 10, 50, "train.forward"),
             (1, 12, 30, "stem"), (1, 60, 90, "train.backward"),
             (2, 0, 100, "train.forward")]
    tl = S.Timeline(spans, [(0, 15), (20, 25), (40, 70), (80, 100)])
    assert tl.idle() == [(15, 20), (25, 40), (70, 80)]
    assert tl.idle_within(1, "train.forward") == 5 + 15
    assert tl.idle_within(1, "train.backward") == 10
    assert tl.idle_within(1, "optimizer") == 0


class _Ev:
    """A Kineto event: ``kind`` is its Chrome trace category."""

    def __init__(self, kind, name, start, end, tid=1, user=False):
        self.v = (kind, name, start, end, tid, user)

    def device_type(self):
        on = self.v[0] in ("kernel", "gpu_memcpy", "gpu_memset",
                           "gpu_user_annotation")
        return types.SimpleNamespace(name="CUDA" if on else "CPU")

    def name(self):
        return self.v[1]

    def start_ns(self):
        return self.v[2]

    def end_ns(self):
        return self.v[3]

    def start_thread_id(self):
        return self.v[4]

    def is_user_annotation(self):
        return self.v[5]


def _run(events, records=None, workload=None):
    res = types.SimpleNamespace(events=lambda: events)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=res))
    tr = types.SimpleNamespace(prof=prof, ops=[], on_device=True)
    return types.SimpleNamespace(trace=tr, records=records or {},
                                 workload=workload or {})


def test_readers_on_hand_built_events():
    """Program spans are kept; torch's own ranges, host ops and the
    annotations' mirrors on the device are not; device ops of every kind
    count; the readers read them."""
    ev = [_Ev("user_annotation", "predict", 0, 100, user=True),
          _Ev("gpu_user_annotation", "predict", 30, 95, tid=0, user=True),
          _Ev("user_annotation", "predict.copy_in", 0, 40, user=True),
          _Ev("user_annotation", "Optimizer.step#Adam.step", 50, 60,
              user=True),
          _Ev("user_annotation", "predict.copy_out", 80, 100, user=True),
          _Ev("cpu_op", "aten::copy_", 5, 35),
          _Ev("gpu_memcpy", "Memcpy HtoD", 30, 40, tid=0),
          _Ev("kernel", "k", 50, 80, tid=0),
          _Ev("gpu_memset", "Memset", 90, 95, tid=0)]
    run = _run(ev)
    tl = S.timeline(run)
    assert [s[3] for s in tl.spans] == ["predict", "predict.copy_in",
                                        "predict.copy_out"]
    assert tl.device == [(30, 40), (50, 80), (90, 95)]
    assert S.timeline(run) is tl                  # read once a run
    assert S.mean_span_ms(run, "predict.copy_in") == pytest.approx(4e-5)
    # idle 40-50 under predict, 80-90 under predict.copy_out
    assert S.idle_share(run, ("predict.copy_in", "predict.copy_out")) == \
        pytest.approx(50.0)
    assert S.mean_span_ms(run, "prefetch.wait") is None


def test_readers_give_none_without_spans_or_events():
    """An older program (no spans) and a profiler without Kineto events
    give None, and no error."""
    ops = [_Ev("kernel", "k", 0, 10, tid=0), _Ev("kernel", "k", 20, 30,
                                                  tid=0)]
    for run in (_run(ops), types.SimpleNamespace(
            trace=types.SimpleNamespace(prof=None, ops=[], on_device=True),
            records={}, workload={})):
        for name in ("copy_in_ms.serve", "idle_in_copies_share.serve",
                     "idle_in_model_share.serve", "prefetch_wait_ms.train",
                     "idle_in_put_share.train",
                     "idle_in_optimizer_share.train",
                     "idle_in_forward_share.train",
                     "idle_in_backward_share.train"):
            assert H.load_module("metrics", name).read(run) is None
    run = _run([], records={"batch": 2, "trace_images": 4},
               workload={"crf": True})
    run.trace.ops = [("k", "predict/predict.model/stem", 5.0, {})]
    for name in ("crf_span_roofline.serve", "crf_norm_ms.serve",
                 "crf_splat_ms.serve", "crf_blur_ms.serve",
                 "crf_step_ms.serve"):
        assert H.load_module("metrics", name).read(run) is None


def test_timeline_surfaces_a_reader_fault():
    """Only a profiler without Kineto events reads as no timeline; a fault
    in reading the events is raised."""
    def broken():
        raise RuntimeError("bad event")
    run = _run([])
    run.trace.prof.profiler.kineto_results.events = broken
    with pytest.raises(RuntimeError):
        S.timeline(run)


def test_idle_within_and_crf_family_readers():
    ev = [_Ev("user_annotation", "predict", 0, 200, user=True),
          _Ev("user_annotation", "predict.model", 10, 100, user=True),
          _Ev("user_annotation", "stem", 10, 40, user=True),
          _Ev("user_annotation", "predict.crf", 100, 190, user=True),
          _Ev("kernel", "k", 0, 20, tid=0), _Ev("kernel", "k", 30, 120,
                                                 tid=0),
          _Ev("kernel", "k", 150, 200, tid=0)]
    run = _run(ev, records={"batch": 2, "trace_images": 4})
    # idle 20-30 (inside stem, so inside predict.model) and 120-150
    read = H.load_module("metrics", "idle_in_model_share.serve").read
    assert read(run) == pytest.approx(25.0)
    assert H.load_module("metrics", "idle_in_forward_share.train").read(
        run) is None
    run.trace.ops = [("a", "predict/predict.crf/crf.blur", 300.0, {}),
                     ("b", "predict/predict.crf/crf.blur", 100.0, {}),
                     ("c", "predict/predict.crf/crf.step", 50.0, {}),
                     ("d", "predict/predict.crf", 7.0, {})]
    ms = {f: H.load_module("metrics", f"crf_{f}_ms.serve").read(run)
          for f in ("norm", "splat", "blur", "step")}
    assert ms == {"norm": None, "splat": None,
                  "blur": pytest.approx(0.2), "step": pytest.approx(0.025)}


def test_crf_span_roofline_reads_the_crf_scope():
    run = _run([], records={"batch": 2, "trace_images": 4},
               workload={"crf": True})
    run.size = (64, 64)
    run.config = H.cell_files(H.benchmark(), "mnv2_crf_b16")[2]
    run.trace.ops = [("splat", "predict/predict.crf/crf.splat", 30.0, {}),
                     ("glue", "predict/predict.crf", 10.0, {}),
                     ("conv", "predict/predict.model/stem", 500.0, {})]
    got = H.load_module("metrics", "crf_span_roofline.serve").read(run)
    from portbench.work import crf as WC
    from portbench.work.peaks import bound_s
    want = bound_s(WC.flops(run.config["crf"], 2, 64, 64, 21),
                   WC.io_bytes(2, 64, 64)) * 2 / 40e-6 * 100
    assert got == pytest.approx(want)


def test_span_readers_on_a_traced_cpu_run():
    """A traced CPU run of the serving cell: the host spans are read (no
    device ops on the CPU, so the idle shares give none)."""
    args = argparse.Namespace(workload="xc16_serve_b16", seed=2 ** 31 + 5,
                              seconds=1.2, trace=1)
    small = {"batch": 2, "pool_batches": 2, "warmup_calls": 1,
             "sample_calls": 1, "trace_seconds": 0.5}
    result, _ = RUN.execute(args, device=torch.device("cpu"),
                            size=(64, 64), overrides=small)
    m = result["metrics"]
    assert m["copy_in_ms.serve"]["value"] > 0
    assert "idle_in_copies_share.serve" not in m
