"""Batching inference server (deeplab_tpu/serve.py): the production serving
loop over the port's pipeline.

``BatchingServer`` fronts a pipeline (a :class:`~deeplab_tpu_torch.Predictor`
or any callable from a float32 (B, H, W, 3) BGR batch to (B, H, W) integer
masks) with an HTTP endpoint from the standard library that **dynamically
batches** concurrent requests: the dispatcher collects up to ``max_batch``
queued images (waiting at most ``max_wait_ms`` after the first), runs ONE
device call, and fans the masks back out.  A single straggler still serves
at B=1 latency; concurrent load rides the batched throughput curve.  The
device call runs on the dispatcher's own thread, so every kernel of the
pipeline launches from that one thread, on its current CUDA stream.

Endpoints:
  - ``POST /predict``: body = an encoded image (anything PIL decodes: JPEG,
    PNG, ...).  Response: a PNG label mask (mode L, one byte a pixel) at the
    model's size, with ``X-Classes`` listing the classes present.
  - ``GET /healthz``: JSON meta (image size, batch limits, anything given
    in ``meta``).

Serve a live Predictor on the card::

    from deeplab_tpu_torch import Predictor
    from deeplab_tpu_torch.crf import PRODUCTION_CONFIG
    from deeplab_tpu_torch.serve import BatchingServer
    pred = Predictor(net, crf=PRODUCTION_CONFIG)    # net: a SegNet
    BatchingServer(pred, net.sz, max_batch=16).serve_forever(port=8517)

PIL is imported by the functions that decode and encode, never with this
module.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np


def _decode_bgr(data: bytes, size_wh) -> np.ndarray:
    """Encoded image bytes -> float32 BGR (H, W, 3) at the model size (the
    generator's cv2-imread contract, reference utils.py:315)."""
    from PIL import Image
    from deeplab_tpu_torch.data.augment import resize_bilinear
    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im.convert("RGB"))[..., ::-1]
    return resize_bilinear(arr, size_wh).astype(np.float32)


def _one_line(e: Exception, limit: int = 300) -> str:
    """First line of an exception message: anything with CR/LF must never
    reach an HTTP status line."""
    text = f"{type(e).__name__}: {e}"
    return text.splitlines()[0][:limit] if text else type(e).__name__


def _encode_mask_png(mask: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(mask.astype(np.uint8), mode="L").save(buf, format="PNG")
    return buf.getvalue()


class _Dispatcher:
    """Collect queued images, run one batched device call, fan results out."""

    def __init__(self, predict_fn: Callable, max_batch: int,
                 max_wait_ms: float):
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.q: queue.Queue = queue.Queue()
        self._stop = object()
        self._closed = False
        # serializes the closed-check+enqueue against shutdown, so no item
        # can land in the queue after the _stop sentinel (an unserviced
        # enqueue would block its submit() forever)
        self._lock = threading.Lock()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, img: np.ndarray):
        """Blocking: returns this image's (H, W) mask."""
        slot = {"event": threading.Event()}
        with self._lock:
            if self._closed:
                raise RuntimeError("dispatcher is shut down")
            self.q.put((img, slot))
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["mask"]

    def shutdown(self):
        with self._lock:
            self._closed = True
            self.q.put(self._stop)
        self.thread.join(timeout=5)

    def _gather(self):
        item = self.q.get()
        if item is self._stop:
            return None
        batch = [item]
        t_end = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is self._stop:
                self.q.put(self._stop)  # re-queue for the outer loop
                break
            batch.append(nxt)
        return batch

    def _bucket(self, n: int) -> int:
        """Pad gathered batches up to a power-of-2 bucket (at most
        max_batch), so the device sees at most log2(max_batch) + 1 batch
        shapes: each new shape costs its launch plans and cuDNN's algorithm
        choice on the one dispatcher thread, in front of everyone queued."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _loop(self):
        while True:
            batch = self._gather()
            if batch is None:
                break
            imgs = np.stack([b[0] for b in batch])
            pad = self._bucket(len(batch)) - len(batch)
            if pad > 0:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad,
                                                       axis=0)])
            try:
                masks = self.predict_fn(imgs)
                for i, (_, slot) in enumerate(batch):
                    slot["mask"] = np.asarray(masks[i])
                    slot["event"].set()
            except Exception as e:  # surface device errors to every caller
                for _, slot in batch:
                    slot["error"] = e
                    slot["event"].set()
        # drain anything that raced shutdown so no submit() waits forever
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                return
            if item is not self._stop:
                item[1]["error"] = RuntimeError("dispatcher is shut down")
                item[1]["event"].set()


class BatchingServer:
    """HTTP front end over a pipeline.

    ``pipeline``: any callable mapping a float32 (B, H, W, 3) BGR batch to
    (B, H, W) integer masks: a ``Predictor`` or a plain function.
    ``image_size``: (H, W) the pipeline expects.  A pipeline with a fixed
    ``batch`` attribute bounds ``max_batch``.
    """

    def __init__(self, pipeline: Callable, image_size, max_batch: int = 8,
                 max_wait_ms: float = 10.0, meta: Optional[dict] = None,
                 max_body_bytes: int = 64 << 20):
        self.sz = tuple(image_size)
        self.max_body = max_body_bytes
        # a fixed-batch pipeline rejects batches beyond its size: bound the
        # gather so a full bucket can never exceed it
        fixed_batch = getattr(pipeline, "batch", None)
        if fixed_batch:
            max_batch = min(max_batch, fixed_batch)
        self.meta = dict(meta or {})
        self.meta.update(image_size=list(self.sz), max_batch=max_batch,
                         max_wait_ms=max_wait_ms)
        self.dispatcher = _Dispatcher(pipeline, max_batch, max_wait_ms)
        self._httpd = None

    def _handler_class(server):
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def do_GET(self):
                if self.path.rstrip("/") in ("", "/healthz"):
                    body = json.dumps({"status": "ok", **server.meta},
                                      default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path.rstrip("/") != "/predict":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self.send_error(400, "bad Content-Length")
                    return
                if not 0 < n <= server.max_body:
                    self.send_error(
                        400 if n <= 0 else 413,
                        f"body must be 1..{server.max_body} bytes")
                    return
                data = self.rfile.read(n)
                try:
                    img = _decode_bgr(data, server.sz[::-1])
                except Exception as e:
                    # single-line reason: multi-line exception text would
                    # corrupt the HTTP status line (CR/LF injection)
                    self.send_error(400, "undecodable image",
                                    explain=_one_line(e))
                    return
                try:
                    mask = server.dispatcher.submit(img)
                except Exception as e:
                    self.send_error(500, "inference failed",
                                    explain=_one_line(e))
                    return
                body = _encode_mask_png(mask)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Classes", ",".join(
                    str(c) for c in np.unique(mask)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 8517):
        """Bind and serve on a background thread; returns the bound port
        (pass ``port=0`` for an ephemeral one)."""
        from http.server import ThreadingHTTPServer
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._handler_class())
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        self._thread = t
        return self._httpd.server_address[1]

    def serve_forever(self, host: str = "0.0.0.0", port: int = 8517):
        port = self.start(host, port)
        print(f"serving on http://{host}:{port}  "
              f"(POST /predict, GET /healthz)")
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.dispatcher.shutdown()
