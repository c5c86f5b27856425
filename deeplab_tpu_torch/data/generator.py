"""In-memory batches, a background prefetch thread and the image readers
(the port's copy of ``ArrayBatcher``, ``Prefetcher``, ``_imread_bgr`` and
``_imread_gray`` of deeplab_tpu/data/generator.py; PIL is imported by the
readers, never with the module).

A batch is ``(X, Y, {"pred_mask": SW})``: X (b, H, W, 3) float BGR 0-255,
Y (b, H*W, 1) labels (``n_classes`` is void), SW (b, H*W) per-pixel weights.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np


def _imread_bgr(path: str) -> np.ndarray:
    """Read an image as uint8 BGR (the reference's cv2.imread contract,
    utils.py:315).  PIL decodes; the channels are swapped to BGR."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    return arr[..., ::-1].copy()


def _imread_gray(path: str) -> np.ndarray:
    """Read a label map as uint8 single channel (utils.py:316).  A
    palettized PNG (the VOC label format) gives its palette indices, as
    cv2.imread(path, 0) does on VOC SegmentationClassAug files."""
    from PIL import Image
    with Image.open(path) as im:
        if im.mode in ("P", "L"):
            return np.asarray(im.convert("L") if im.mode == "L" else im).copy()
        return np.asarray(im.convert("L")).copy()


class ArrayBatcher:
    """In-memory batcher (reference ``SegModel.train``).  Unweighted unless
    ``sample_weights`` is given."""

    def __init__(self, X, Y, batch_size: int, n_classes: int = 21,
                 sample_weights=None):
        self.X = np.asarray(X)
        self.Y = np.asarray(Y)
        if self.Y.ndim == 2:
            self.Y = self.Y[..., None]
        self.batch_size = batch_size
        self.n_classes = n_classes
        if sample_weights is not None:
            self.SW = np.asarray(sample_weights, "float32")
        else:
            self.SW = np.ones((len(self.Y), self.Y.shape[1]), "float32")

    def __len__(self):
        return max(len(self.X) // self.batch_size, 1)

    def __getitem__(self, i):
        sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
        return self.X[sl], self.Y[sl], {"pred_mask": self.SW[sl]}

    def on_epoch_end(self):
        pass


class _PipelineError:
    """Carries a worker's exception to the consumer."""

    def __init__(self, exc):
        self.exc = exc


class Prefetcher:
    """Background-thread prefetch queue over a generator, so the host
    pipeline stays ahead of the device step.  Batches are copied before
    they are queued (a generator may reuse its buffers)."""

    def __init__(self, gen, max_queue_size: int = 10):
        self.gen = gen
        self.max_queue_size = max_queue_size
        self.q: queue.Queue = queue.Queue(maxsize=max_queue_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _copy_batch(batch):
        def cp(x):
            if isinstance(x, dict):
                return {k: cp(v) for k, v in x.items()}
            return np.copy(x)
        return tuple(cp(b) for b in batch)

    def _put(self, q, stop, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, q, stop, indices):
        try:
            for i in indices:
                if stop.is_set():
                    return
                if not self._put(q, stop, self._copy_batch(self.gen[i])):
                    return
        except BaseException as e:  # propagate to the consumer
            self._put(q, stop, _PipelineError(e))
            return
        self._put(q, stop, None)

    def __iter__(self):
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5)
        self._stop = threading.Event()
        self.q = queue.Queue(maxsize=self.max_queue_size)
        self._thread = threading.Thread(
            target=self._worker, args=(self.q, self._stop,
                                       range(len(self.gen))), daemon=True)
        self._thread.start()
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, _PipelineError):
                raise RuntimeError(
                    "data pipeline worker failed") from item.exc
            yield item

    def close(self):
        self._stop.set()
