"""The port's program spans (``core.annotate``) at its layer boundaries,
on the CPU at 32x32 on one torch thread.

- The span tree, in order, of one ``Predictor`` call with the production
  CRF (``predict`` over ``predict.copy_in``, ``predict.model`` around the
  model labels, ``predict.crf`` around ``crf.norm`` and each iteration's
  ``crf.blur``, ``crf.splat`` and ``crf.step``, ``predict.copy_out``; with
  ``return_raw`` a ``predict.copy_out`` between ``predict.model`` and
  ``predict.crf``), of one ``Trainer.train_step`` (``train_step`` over
  ``train.put``, ``train.forward``, ``loss``, ``train.backward``,
  ``optimizer``, ``step_metrics``) and of one ``Prefetcher`` batch
  (``prefetch.wait`` on the consumer's thread, nothing on the loader's),
  read from the profiler's events with their absolute times.
- No ``record_function`` without a profiler; the masks equal bit for bit
  with the spans on.  One CRF ``Predictor`` call, plain and traced, serves
  these tests.
- No span name holds ``/`` or one of the JAX labels.
"""

import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from deeplab_tpu_torch import Predictor
from deeplab_tpu_torch.crf import PRODUCTION_CONFIG
from deeplab_tpu_torch.data.generator import Prefetcher
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.train import Trainer

from test_torch_regions import LABEL, _Recorder

SZ, N = (32, 32), 3
PROGRAM = ("predict", "predict.copy_in", "predict.model", "predict.crf",
           "predict.copy_out", "crf.norm", "crf.blur", "crf.splat",
           "crf.step", "train_step", "train.put", "train.forward",
           "train.backward", "prefetch.wait")
JAX_LABELS = ("stem", "aspp", "head", "loss", "optimizer", "step_metrics",
              "xstem", "xentry", "xmid", "xexit")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profile(fn, all_threads=False):
    """Run ``fn`` under a CPU profiler; returns its result and the spans
    as (thread, depth, name), each thread's in order of start."""
    cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads \
        else None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        out = fn()
    spans = sorted(((e.start_thread_id(), e.start_ns(), -e.end_ns(),
                     e.name()) for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()))
    tree, stack = [], []
    for tid, start, neg_end, name in spans:
        while stack and (stack[-1][0] != tid or stack[-1][1] <= start):
            stack.pop()
        tree.append((tid, len(stack), name))
        stack.append((tid, -neg_end))
    return out, tree


def _program(tree, tid=None):
    """(depth among program spans, name) of the program's spans."""
    out = []
    for t, depth, name in tree:
        if name in PROGRAM and (tid is None or t == tid):
            out.append((depth, name))
    return out


def _images(b=2):
    return (np.random.RandomState(0).rand(b, *SZ, 3) * 255).astype(
        np.float32)


@pytest.fixture(scope="module")
def crf_call(one_thread):
    """One CRF ``Predictor`` call on the same images, without a profiler
    (with the ``record_function`` calls it made) and traced."""
    torch.manual_seed(0)
    pred = Predictor(SegNet(SZ, N, alpha=0.35), crf=PRODUCTION_CONFIG,
                     compute_dtype="float32", device="cpu")
    X = _images()
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        plain = pred(X)
        untraced = list(rec.names)
        traced, tree = _profile(lambda: pred(X))
    return {"plain": plain, "untraced": untraced, "recorded": rec.names,
            "traced": traced, "tree": tree}


def test_span_names():
    for name in PROGRAM:
        assert "/" not in name and not LABEL.match(name)
        assert not any(lab in name for lab in JAX_LABELS), name
        assert not any(LABEL.match(part) for part in name.split("."))


def test_predictor_span_tree(crf_call):
    tree = crf_call["tree"]
    it = PRODUCTION_CONFIG.n_iters
    assert _program(tree) == (
        [(0, "predict"), (1, "predict.copy_in"), (1, "predict.model"),
         (1, "predict.crf"), (2, "crf.norm")]
        + [(2, n) for _ in range(it)
           for n in ("crf.blur", "crf.splat", "crf.step")]
        + [(1, "predict.copy_out")])
    # the model's labels sit inside predict.model, and nothing else is
    # labelled
    model = [d for d, n in _program(tree) if n == "predict.model"]
    labels = [(d, n) for _, d, n in tree if n not in PROGRAM]
    assert labels and all(LABEL.match(n) and d > model[0]
                          for d, n in labels)
    assert [n for _, n in labels][:2] == ["stem", "mb00s1"]


def test_predictor_span_tree_return_raw(crf_call):
    """With ``return_raw`` the model's labels leave under a
    ``predict.copy_out`` between ``predict.model`` and ``predict.crf`` (on
    the card their copy overlaps the CRF), the same tree on every device;
    the pair's refined masks are the plain call's."""
    torch.manual_seed(0)
    pred = Predictor(SegNet(SZ, N, alpha=0.35), crf=PRODUCTION_CONFIG,
                     compute_dtype="float32", device="cpu", return_raw=True)
    (raw, refined), tree = _profile(lambda: pred(_images()))
    np.testing.assert_array_equal(refined, crf_call["plain"])
    assert raw.shape == refined.shape and raw.dtype == np.int32
    it = PRODUCTION_CONFIG.n_iters
    assert _program(tree) == (
        [(0, "predict"), (1, "predict.copy_in"), (1, "predict.model"),
         (1, "predict.copy_out"), (1, "predict.crf"), (2, "crf.norm")]
        + [(2, n) for _ in range(it)
           for n in ("crf.blur", "crf.splat", "crf.step")]
        + [(1, "predict.copy_out")])


def test_train_step_span_tree():
    torch.manual_seed(0)
    net = SegNet(SZ, N, alpha=0.35)
    tr = Trainer(net, device="cpu", verbose=0)
    tr.setup(net)
    r = np.random.RandomState(1)
    X = _images()
    Y = r.randint(0, N, (2, SZ[0] * SZ[1], 1))
    SW = np.ones((2, SZ[0] * SZ[1]), np.float32)
    _, tree = _profile(lambda: tr.train_step(X, Y, SW))
    top = [(d, n) for _, d, n in tree if d <= 1]
    assert top == [(0, "train_step"), (1, "train.put"),
                   (1, "train.forward"), (1, "loss"),
                   (1, "train.backward"), (1, "optimizer"),
                   (1, "step_metrics")]
    # below them the model's labels, and torch's own optimizer ranges
    # (``Optimizer.step#Adam.step``)
    inner = [n for _, d, n in tree if d > 1 and "#" not in n]
    assert inner[0] == "stem" and "aspp" in inner
    assert all(LABEL.match(n) for n in inner)
    assert [n for _, d, n in tree if "#" in n] == [
        "Optimizer.zero_grad#Adam.zero_grad", "Optimizer.step#Adam.step"]


def _prefetch_gen(n, batch):
    class Gen:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return batch
    return Gen()


def test_prefetcher_wait_span_on_the_consumer_thread():
    """One ``prefetch.wait`` a batch (and one for the end), each closed
    inside its ``next()``, on the consumer's thread; none on the loader's
    even where the profiler records every thread."""
    batch = (np.ones((2, 4), np.float32), np.zeros((2, 4, 1), np.int32),
             np.ones((2, 4), np.float32))

    def consume():
        got = []
        for b in Prefetcher(_prefetch_gen(2, batch)):
            got.append((b, threading.get_ident()))
        return got
    got, tree = _profile(consume, all_threads=True)
    assert len(got) == 2
    assert all(np.array_equal(a, b) for g, _ in got for a, b in
               zip(g, batch))
    assert [(d, n) for _, d, n in tree] == [(0, "prefetch.wait")] * 3
    assert len({t for t, _, _ in tree}) == 1


def test_no_record_function_without_a_profiler(crf_call, monkeypatch):
    rec = _Recorder(monkeypatch)
    batch = (_images(), np.zeros((2, 4, 1), np.int32),
             np.ones((2, 4), np.float32))
    assert len(list(Prefetcher(_prefetch_gen(2, batch)))) == 2
    assert rec.names == [] and crf_call["untraced"] == []
    assert "predict.crf" in crf_call["recorded"]


def test_same_masks_with_spans_on(crf_call):
    assert np.array_equal(crf_call["plain"], crf_call["traced"])
