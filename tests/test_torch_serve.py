"""The port's batching server (deeplab_tpu_torch/serve.py) on the CPU: the
mirror of tests/test_serve.py (dynamic batching keeps each request's
result, errors reach every caller, plain HTTP), and the port's server over
its Predictor against the JAX package's server over the JAX Predictor on
the same PNG bytes.

The JAX test's case over an exported artifact has no counterpart yet (the
port's export is a later slice); the fixed-batch clamp is held with a
plain callable that has a ``batch``.  Decoding must give JAX's bytes
exactly (JAX's native resize off, see tests/test_torch_predict_files.py).
Masks of the two servers over the trained 3-class weights in float32: the
same pixels on at least 0.999 of them (tests/test_torch_predictor.py's
float32 floor).
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from deeplab_tpu.data import augment as JA
from deeplab_tpu import serve as jserve

from deeplab_tpu_torch.data.augment import resize_bilinear
from deeplab_tpu_torch.serve import (BatchingServer, _Dispatcher, _decode_bgr,
                                     _encode_mask_png)

SZ = (32, 32)
H5 = os.path.join(os.path.dirname(__file__), "data", "mini_voc_trained.h5")
F32_FLOOR = 0.999


def _fake_pipeline(batch):
    """Deterministic mask: every pixel = (mean of its image) mod 21."""
    vals = (batch.mean(axis=(1, 2, 3)).astype(np.int32)) % 21
    return np.broadcast_to(vals[:, None, None],
                           (batch.shape[0],) + SZ).copy()


def _png_bytes(seed, shape=(40, 44, 3)):
    rng = np.random.RandomState(seed)
    arr = (rng.rand(*shape) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")  # lossless: exact decode
    return buf.getvalue(), arr


def _post(port, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=data, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers, np.asarray(Image.open(io.BytesIO(r.read())))


def test_dispatcher_batches_and_routes_results():
    calls = []

    def pipeline(batch):
        calls.append(batch.shape[0])
        return _fake_pipeline(batch)

    d = _Dispatcher(pipeline, max_batch=4, max_wait_ms=500.0)
    imgs = [np.full(SZ + (3,), v, np.float32) for v in (10.0, 20.0, 30.0)]
    results = [None] * 3

    def worker(i):
        results[i] = d.submit(imgs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    d.shutdown()
    for i, v in enumerate((10, 20, 30)):
        assert results[i] is not None
        np.testing.assert_array_equal(results[i],
                                      np.full(SZ, v % 21, np.int32))
    # concurrency made at least one multi-image batch, and every device
    # call was padded to a power-of-2 bucket
    assert len(calls) < 3
    assert all(c in (1, 2, 4) for c in calls)


@pytest.mark.parametrize("n,max_batch,want", [
    (1, 16, 1), (2, 16, 2), (3, 16, 4), (5, 16, 8), (9, 16, 16),
    (16, 16, 16), (5, 6, 6)])
def test_dispatcher_buckets_match_jax(n, max_batch, want):
    d = _Dispatcher(_fake_pipeline, max_batch=max_batch, max_wait_ms=1.0)
    jd = jserve._Dispatcher(_fake_pipeline, max_batch=max_batch,
                            max_wait_ms=1.0)
    try:
        assert d._bucket(n) == jd._bucket(n) == want
    finally:
        d.shutdown()
        jd.shutdown()


def test_dispatcher_routes_each_result_under_many_clients():
    """More client threads than cores and a short switch interval: every
    caller gets its own image's mask, every device call is one bucket, and
    no image is served twice or dropped."""
    import sys
    served = []
    lock = threading.Lock()

    def pipeline(batch):
        with lock:
            served.append(batch.shape[0])
        return _fake_pipeline(batch)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    d = _Dispatcher(pipeline, max_batch=8, max_wait_ms=2.0)
    n_clients, per_client = 4 * (os.cpu_count() or 1) + 8, 5
    results, errors = {}, []

    def client(c):
        try:
            for k in range(per_client):
                v = float((c * per_client + k) % 21)
                results[c, k] = d.submit(np.full(SZ + (3,), v, np.float32))
        except Exception as e:   # reported below, not lost in the thread
            errors.append(e)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        d.shutdown()
        sys.setswitchinterval(old)
    assert len(results) == n_clients * per_client
    for (c, k), mask in results.items():
        np.testing.assert_array_equal(
            mask, np.full(SZ, (c * per_client + k) % 21, np.int32))
    assert all(b in (1, 2, 4, 8) for b in served)
    assert sum(served) >= len(results)


def test_dispatcher_shutdown_unblocks_racing_submits():
    """A submit that lands after shutdown must error, not hang."""
    d = _Dispatcher(_fake_pipeline, max_batch=2, max_wait_ms=1.0)
    d.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        d.submit(np.zeros(SZ + (3,), np.float32))


def test_dispatcher_propagates_errors():
    def boom(batch):
        raise RuntimeError("device on fire")

    d = _Dispatcher(boom, max_batch=2, max_wait_ms=1.0)
    with pytest.raises(RuntimeError, match="device on fire"):
        d.submit(np.zeros(SZ + (3,), np.float32))
    d.shutdown()


@pytest.fixture(scope="module")
def server():
    srv = BatchingServer(_fake_pipeline, SZ, max_batch=4, max_wait_ms=5.0,
                         meta={"pipeline": "test"})
    port = srv.start(port=0)
    yield srv, port
    srv.stop()


def test_healthz(server):
    _, port = server
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["image_size"] == list(SZ)
    assert body["pipeline"] == "test"


def test_predict_endpoint_round_trip(server):
    _, port = server
    data, arr = _png_bytes(0)
    headers, mask = _post(port, data)
    assert headers["Content-Type"] == "image/png"
    assert mask.shape == SZ
    # decoded as BGR and bilinear-resized like the Predictor's file path
    expect = _fake_pipeline(
        resize_bilinear(arr[..., ::-1], SZ[::-1]).astype(np.float32)[None])[0]
    np.testing.assert_array_equal(mask, expect)
    assert headers["X-Classes"] == ",".join(str(c) for c in np.unique(expect))


def test_predict_concurrent_requests_batch(server):
    _, port = server
    results = {}

    def post(i):
        results[i] = _post(port, _png_bytes(i)[0])[1]

    threads = [threading.Thread(target=post, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 5
    for i in range(5):
        _, arr = _png_bytes(i)
        expect = _fake_pipeline(resize_bilinear(
            arr[..., ::-1], SZ[::-1]).astype(np.float32)[None])[0]
        np.testing.assert_array_equal(results[i], expect)


def test_bad_request_and_404(server):
    _, port = server
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=b"not an image", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
    assert e.value.code == 404


def test_oversized_and_bogus_content_length(server):
    _, port = server
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    # an absurd Content-Length is rejected up front (no buffering attempt)
    conn.request("POST", "/predict", body=b"x",
                 headers={"Content-Length": str(10 ** 10)})
    assert conn.getresponse().status == 413
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/predict", body=b"",
                 headers={"Content-Length": "0"})
    assert conn.getresponse().status == 400
    conn.close()


def test_fixed_batch_pipeline_clamps_max_batch():
    """A fixed-batch pipeline bounds the gather: a full bucket must never
    exceed what it can execute."""
    class Fixed:
        batch = 2

        def __call__(self, b):
            assert b.shape[0] <= 2
            return _fake_pipeline(b)

    srv = BatchingServer(Fixed(), SZ, max_batch=8, max_wait_ms=1.0)
    try:
        assert srv.dispatcher.max_batch == 2
        assert srv.meta["max_batch"] == 2
    finally:
        srv.stop()


def test_multiline_device_error_yields_clean_500():
    """Multi-line exception text must not reach the HTTP status line."""
    def boom(batch):
        raise RuntimeError("device exploded\nlong traceback line\nmore")

    srv = BatchingServer(boom, SZ, max_batch=2, max_wait_ms=1.0)
    port = srv.start(port=0)
    try:
        data, _ = _png_bytes(1)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=data, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 500
        assert "\n" not in e.value.reason and "\r" not in e.value.reason
        body = e.value.read().decode()
        assert "device exploded" in body      # the detail is in the body
    finally:
        srv.stop()


@pytest.mark.parametrize("shape", [(40, 44, 3), (32, 32, 3), (17, 60, 3)])
def test_decode_matches_jax(monkeypatch, shape):
    monkeypatch.setattr(JA._native, "available", lambda: False)
    data, _ = _png_bytes(7, shape)
    got = _decode_bgr(data, SZ[::-1])
    want = jserve._decode_bgr(data, SZ[::-1])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    mask = got[..., 0].astype(np.int32) % 21
    assert _encode_mask_png(mask) == jserve._encode_mask_png(mask)


def test_server_over_predictor_matches_jax(monkeypatch):
    """End to end: each package's server over its own Predictor on the
    trained weights, the same PNG bytes (mini_voc tiles) POSTed to both."""
    import jax
    import jax.numpy as jnp
    from deeplab_tpu.models.seg_model import SegNet as JSegNet
    from deeplab_tpu.params import load_keras_h5 as jload
    from deeplab_tpu.predictor import Predictor as JPredictor
    from deeplab_tpu_torch import Predictor, SegNet
    from deeplab_tpu_torch.params import load_keras_h5
    monkeypatch.setattr(JA._native, "available", lambda: False)
    size = (64, 64)
    jnet = JSegNet(size, 3, "mobilenetv2", "original")
    params, state = jload(H5, *jnet.init(jax.random.key(0)))
    servers = [
        BatchingServer(Predictor(load_keras_h5(H5, SegNet(size, 3)),
                                 compute_dtype="float32", device="cpu"),
                       size, max_batch=4, max_wait_ms=20.0),
        jserve.BatchingServer(JPredictor(jnet, params, state, crf=None,
                                         compute_dtype=jnp.float32),
                              size, max_batch=4, max_wait_ms=20.0)]
    ports = [s.start(port=0) for s in servers]
    d = os.path.join(os.path.dirname(__file__), "data", "mini_voc",
                     "JPEGImages", "train")
    try:
        masks = [[], []]
        for f in sorted(os.listdir(d))[:4]:
            with open(os.path.join(d, f), "rb") as fh:
                data = fh.read()
            for k, port in enumerate(ports):
                headers, mask = _post(port, data)
                assert mask.shape == size
                masks[k].append(mask)
        got, want = np.stack(masks[0]), np.stack(masks[1])
        assert len(np.unique(want)) > 1
        agree = float((got == want).mean())
        assert agree >= F32_FLOOR, agree
    finally:
        for s in servers:
            s.stop()
