"""The Predictor's host-device copies (``predictor.py``): pinned staging in
chunks on the card, the direct copies elsewhere.

Imports only torch and numpy, so the card's tests run on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_predictor_copies.py

On the card (each skips without CUDA): staged calls on host float32 and
uint8 arrays give the labels of the direct path (the same Predictor fed a
device tensor) bit for bit, with the production CRF and ``return_raw`` and
without a CRF; the returned arrays are the caller's (unchanged by later
calls, not pinned); two pipelines enqueued before either is fetched, as
``predict_files`` does, give the one-at-a-time masks; ``copy_stats()``
counts every call as staged; the span tree of a ``return_raw`` call holds
the early ``predict.copy_out`` before ``predict.crf``.  On the CPU: the
chunk plan, and a CPU Predictor on the direct path with the model's masks.
"""

import numpy as np
import pytest
import torch

from deeplab_tpu_torch import predictor as P
from deeplab_tpu_torch.crf import PRODUCTION_CONFIG, dense_crf
from deeplab_tpu_torch.models.seg_model import SegNet

SZ, N_CLS, B = (64, 64), 3, 4
PROGRAM = ("predict", "predict.copy_in", "predict.model", "predict.crf",
           "predict.copy_out")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staged copies are pinned DMA")
    return torch.device("cuda")


def _images(seed, b=B):
    r = np.random.RandomState(seed)
    return (r.rand(b, *SZ, 3) * 255).astype(np.uint8)


def _predictor(device, crf):
    torch.manual_seed(0)
    net = SegNet(SZ, N_CLS, alpha=0.35)
    if crf:
        return P.Predictor(net, crf=PRODUCTION_CONFIG, return_raw=True,
                           compute_dtype="mixed", device=device)
    return P.Predictor(net, compute_dtype="mixed", device=device)


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == np.int32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape, itemsize, step, chunks", [
    ((1, 512, 512, 3), 4, 5, 1),       # B=1: one chunk
    ((16, 512, 512, 3), 4, 5, 4),      # 3.1 MB images: five a chunk
    ((16, 512, 512, 3), 1, 21, 1),     # uint8 crosses as is: 0.8 MB images
    ((2, 4096, 2048, 3), 4, 1, 2),     # an item past a chunk is one chunk
    ((0, 512, 512, 3), 4, 5, 0),
])
def test_chunk_plan(shape, itemsize, step, chunks):
    got = P._chunk_items(shape, itemsize)
    assert got == step
    assert len(range(0, shape[0], got)) == chunks


def test_chunk_plan_is_a_few_mb():
    per = 512 * 512 * 3 * 4
    step = P._chunk_items((16, 512, 512, 3), 4)
    assert 2 << 20 <= step * per <= P._CHUNK_BYTES
    assert -(-16 // step) > 1      # B=16 pipelines in several chunks


@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf_raw"])
def test_cpu_takes_the_direct_path(crf):
    pred = _predictor("cpu", crf)
    X = _images(1)
    got = pred(X)
    with torch.inference_mode():
        img = torch.from_numpy(X).to(torch.float32)
        raw = pred.net.predict_ids(img, pred.policy)
        want = raw.numpy()
        if crf:
            ref = dense_crf.mean_field_batched(img, raw, PRODUCTION_CONFIG,
                                               N_CLS)
            want = (want, ref.numpy())
    _same(got, want)
    pred(X.astype(np.float32))
    st = pred.copy_stats()
    assert st == {"calls": 2, "staged_in": 0, "staged_out": 0,
                  "bytes_in": 0, "bytes_out": 0, "chunks_in": 0}
    assert not pred._pinned


@pytest.mark.gpu
@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf_raw"])
def test_staged_equals_direct(cuda, crf, monkeypatch):
    # chunks of one image, so a call pipelines in B chunks
    monkeypatch.setattr(P, "_CHUNK_BYTES", SZ[0] * SZ[1] * 3)
    pred = _predictor(cuda, crf)
    X = _images(2)
    direct = pred(torch.from_numpy(X).to(cuda))
    for x in (X.astype(np.float32), X):
        _same(pred(x), direct)
    _same(pred(torch.from_numpy(X.astype(np.float32)).to(cuda)), direct)
    st = pred.copy_stats()
    assert st["calls"] == 4 and st["staged_in"] == 2
    assert st["staged_out"] == 4
    assert st["chunks_in"] == 2 * B
    assert st["bytes_in"] == X.nbytes * 4 + X.nbytes
    per = X.shape[0] * SZ[0] * SZ[1] * 4
    assert st["bytes_out"] == 4 * per * (2 if crf else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf_raw"])
def test_returned_arrays_are_the_callers(cuda, crf):
    pred = _predictor(cuda, crf)
    X1, X2 = _images(3), _images(4)
    first = pred(X1)
    keep = [a.copy() for a in (first if crf else (first,))]
    for seed in (5, 6, 7):
        pred(_images(seed))
    pred(X2)
    for a, k in zip(first if crf else (first,), keep):
        np.testing.assert_array_equal(a, k)
        assert not torch.from_numpy(a).is_pinned()
        assert not any(np.shares_memory(a, buf.numpy())
                       for free in pred._pinned.values()
                       for buf, _ in free)


@pytest.mark.gpu
@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf_raw"])
def test_two_pipelines_in_flight(cuda, crf):
    pred = _predictor(cuda, crf)
    X1, X2 = _images(8), _images(9)
    one = [pred(X1), pred(X2)]
    a = pred._run(X1.astype(np.float32))
    b = pred._run(X2.astype(np.float32))
    _same(pred._fetch(a), one[0])
    _same(pred._fetch(b), one[1])
    # a fetch of the first items only, as predict_files' last batch
    _same(pred._fetch(pred._run(X1), 3),
          tuple(o[:3] for o in one[0]) if crf else one[0][:3])


@pytest.mark.gpu
def test_staged_share_is_one(cuda):
    pred = _predictor(cuda, True)
    for seed in range(4):
        pred(_images(seed))
    st = pred.copy_stats()
    assert st["calls"] == 4
    assert st["staged_in"] / st["calls"] == 1.0
    assert st["staged_out"] / st["calls"] == 1.0


@pytest.mark.gpu
def test_return_raw_span_tree(cuda):
    pred = _predictor(cuda, True)
    X = _images(10)
    plain = pred(X)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = pred(X)
    _same(traced, plain)
    spans = sorted((e.start_ns(), -e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name() in PROGRAM
                   and getattr(e.device_type(), "name", "") == "CPU")
    tree, stack = [], []
    for start, neg_end, name in spans:
        while stack and stack[-1] <= start:
            stack.pop()
        tree.append((len(stack), name))
        stack.append(-neg_end)
    # the model's labels leave under predict.copy_out, before the CRF
    assert tree == [(0, "predict"), (1, "predict.copy_in"),
                    (1, "predict.model"), (1, "predict.copy_out"),
                    (1, "predict.crf"), (1, "predict.copy_out")]
