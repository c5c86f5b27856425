"""Data pipeline (deeplab_tpu/data/generator.py): the augmenting
``SegmentationGenerator`` over a VOC-layout folder with the reference's
seeded split, in-memory batches, a background prefetch thread, an ordered
pool of worker processes and the image readers (PIL is imported by the
readers, never with the module).

A batch is ``(X, Y, {"pred_mask": SW})``: X (b, H, W, 3) float BGR 0-255,
Y (b, H*W, 1) labels (``n_classes`` is void), SW (b, H*W) per-pixel weights.
The JAX generator's per-host sharding (its multi-host data parallelism)
comes with the multi-GPU slice.  The module imports numpy and the standard
library only: the worker processes import it, and never torch.
"""

from __future__ import annotations

import contextlib
import glob
import os
import queue
import random
import sys
import threading
from typing import Optional

import numpy as np

from deeplab_tpu_torch.data import augment as A
from deeplab_tpu_torch.data.class_weights import (adaptive_pixel_weights,
                                                  fg_bg_pixel_weights)


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


def reference_split(n_images: int, validation_split: float, seed: int,
                    mode: str) -> np.ndarray:
    """The reference's exact index selection (utils.py:268-276)."""
    np.random.seed(seed)
    n_select = round(n_images * validation_split)
    x = np.random.permutation(n_images)[:n_select]
    if mode == "train":
        x = np.setxor1d(x, np.arange(n_images))
    return x


class SegmentationGenerator:
    """Reference utils.py:257-423: batch generator with augmentation (JAX
    ``SegmentationGenerator`` on one host).  ``__getitem__`` returns
    ``(X, Y, {'pred_mask': SW})``: X raw 0-255 float32 BGR, Y flattened
    (H*W, 1) labels with ids that resizing or warping introduced mapped to
    void, SW the adaptive balanced per-pixel weights with void zeroed.
    Augmentation, in the reference's order and with its draws from
    ``random``: blur, resize or random crop, flips, gamma brightness, the
    fused rotation and zoom warp, CLAHE on YUV-Y."""

    def __init__(self, folder="/workspace/datasets/", mode="train",
                 n_classes=21, batch_size=1, resize_shape=None,
                 validation_split=0.1, seed=7, crop_shape=(640, 320),
                 horizontal_flip=True, blur=0, vertical_flip=0,
                 brightness=0.1, rotation=5.0, zoom=0.1, do_ahisteq=True):
        self.blur = blur
        self.histeq = do_ahisteq
        self.image_path_list = sorted(
            glob.glob(os.path.join(folder, "JPEGImages", "train", "*")))
        self.label_path_list = sorted(
            glob.glob(os.path.join(folder, "SegmentationClassAug", "*")))

        x = reference_split(len(self.image_path_list), validation_split, seed,
                            mode)
        self.image_path_list = [self.image_path_list[j] for j in x]
        self.label_path_list = [self.label_path_list[j] for j in x]

        if mode == "test":
            self.image_path_list = sorted(
                glob.glob(os.path.join(folder, "JPEGImages", "test", "*")))[:100]

        self.mode = mode
        self.n_classes = n_classes
        self.batch_size = batch_size
        self.resize_shape = resize_shape      # (W, H), the cv2 order
        self.crop_shape = crop_shape
        self.horizontal_flip = horizontal_flip
        self.vertical_flip = vertical_flip
        self.brightness = brightness
        self.rotation = rotation
        self.zoom = zoom

        if self.crop_shape:
            w, h = crop_shape
        elif self.resize_shape:
            w, h = resize_shape
        else:
            raise Exception("No image dimensions specified!")
        self._hw = (h, w)
        n_px = h * w
        bs = batch_size
        self.X = np.zeros((bs, h, w, 3), dtype="float32")
        self.SW = np.zeros((bs, n_px), dtype="float32")
        self.Y = np.zeros((bs, n_px, 1), dtype="float32")
        self.F = np.zeros((bs, n_px, 1), dtype="float32")
        self.F_SW = np.zeros((bs, n_px), dtype="float32")

    def __len__(self):
        return len(self.image_path_list) // self.batch_size

    def _load_pair(self, image_path: str, label_path: str):
        return _imread_bgr(image_path), _imread_gray(label_path)

    def __getitem__(self, i):
        bs = self.batch_size
        pairs = zip(self.image_path_list[i * bs:(i + 1) * bs],
                    self.label_path_list[i * bs:(i + 1) * bs])
        for n, (image_path, label_path) in enumerate(pairs):
            image, label = self._load_pair(image_path, label_path)
            labels_present = np.unique(label)

            if self.blur and random.randint(0, 1):
                image = A.gaussian_blur(image, self.blur)

            if self.resize_shape and not self.crop_shape:
                image = A.resize_bilinear(image, self.resize_shape)
                label = A.resize_nearest(label, self.resize_shape)

            if self.crop_shape:
                image, label = _random_crop(image, label, self.crop_shape)

            if self.horizontal_flip and random.randint(0, 1):
                image = A.flip_horizontal(image)
                label = A.flip_horizontal(label)
            if self.vertical_flip and random.randint(0, 1):
                image = A.flip_vertical(image)
                label = A.flip_vertical(label)
            if self.brightness:
                factor = 1.0 + random.gauss(mu=0.0, sigma=self.brightness)
                if random.randint(0, 1):
                    factor = 1.0 / factor
                image = A.apply_lut(image, A.gamma_lut(factor))
            angle = random.gauss(mu=0.0, sigma=self.rotation) if self.rotation \
                else 0.0
            scale = random.gauss(mu=1.0, sigma=self.zoom) if self.zoom else 1.0
            if self.rotation or self.zoom:
                h_, w_ = image.shape[:2]
                M = A.rotation_matrix((w_ // 2, h_ // 2), angle, scale)
                image = A.warp_affine(image, M, (w_, h_))
                # the reference warps labels with bilinear too (utils.py:353);
                # interpolation-born ids are voided below.
                label = A.warp_affine(label, M, (w_, h_))

            if self.histeq:
                image = A.clahe_bgr(image)

            label = label.astype("int32")
            # label hygiene (utils.py:360-365): ids not present pre-resize
            # become void.
            for j in np.setxor1d(np.unique(label), labels_present):
                label[label == j] = self.n_classes
            y = label.flatten()
            y[y > (self.n_classes - 1)] = self.n_classes

            self.Y[n] = np.expand_dims(y, -1)
            self.F[n] = (self.Y[n] != 0).astype("float32")
            self.F_SW[n] = fg_bg_pixel_weights(y, self.n_classes)
            self.X[n] = image
            self.SW[n] = adaptive_pixel_weights(y, self.n_classes)

        return self.X, self.Y, {"pred_mask": self.SW}

    def on_epoch_end(self):
        c = list(zip(self.image_path_list, self.label_path_list))
        if not c:  # an empty dataset: nothing to shuffle
            return
        random.shuffle(c)
        self.image_path_list, self.label_path_list = zip(*c)

    # The batch buffers are scratch: a worker process receives the
    # generator by pickle, which leaves them out (tens of MB of zeros at
    # 512x512) and makes them anew on arrival.
    _SCRATCH = ("X", "SW", "Y", "F", "F_SW")

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items()
                if k not in self._SCRATCH}

    def __setstate__(self, state):
        self.__dict__.update(state)
        h, w = self._hw
        n_px = h * w
        bs = self.batch_size
        self.X = np.zeros((bs, h, w, 3), dtype="float32")
        self.SW = np.zeros((bs, n_px), dtype="float32")
        self.Y = np.zeros((bs, n_px, 1), dtype="float32")
        self.F = np.zeros((bs, n_px, 1), dtype="float32")
        self.F_SW = np.zeros((bs, n_px), dtype="float32")


def _random_crop(image, label, crop_shape):
    """Reference utils.py:411-423."""
    if (image.shape[0] != label.shape[0]) or (image.shape[1] != label.shape[1]):
        raise Exception("Image and label must have the same dimensions!")
    if (crop_shape[0] < image.shape[1]) and (crop_shape[1] < image.shape[0]):
        x = random.randrange(image.shape[1] - crop_shape[0])
        y = random.randrange(image.shape[0] - crop_shape[1])
        return (image[y:y + crop_shape[1], x:x + crop_shape[0], :],
                label[y:y + crop_shape[1], x:x + crop_shape[0]])
    image = A.resize_bilinear(image, crop_shape)
    label = A.resize_nearest(label, crop_shape)
    return image, label


class ArrayBatcher:
    """In-memory batcher (reference ``SegModel.train``).  Unweighted, as the
    reference's ``model.fit(X, y)`` is, unless ``sample_weights`` is given
    or ``adaptive_weights`` asks for the generator's balanced per-pixel
    weights of each label map."""

    def __init__(self, X, Y, batch_size: int, n_classes: int = 21,
                 sample_weights=None, adaptive_weights: bool = False):
        self.X = np.asarray(X)
        self.Y = np.asarray(Y)
        if self.Y.ndim == 2:
            self.Y = self.Y[..., None]
        self.batch_size = batch_size
        self.n_classes = n_classes
        if sample_weights is not None:
            self.SW = np.asarray(sample_weights, "float32")
        elif adaptive_weights:
            self.SW = np.stack([adaptive_pixel_weights(y.reshape(-1),
                                                       n_classes)
                                for y in self.Y]).astype("float32")
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


def _mp_worker(gen, indices, q, seed):
    """A worker process: reseed ``random`` and numpy (each worker and epoch
    draws its own augmentations), then put its batches, in order, on its
    own queue.  A batch is copied before ``q.put``: the queue pickles on a
    feeder thread, after the generator may have reused its buffers."""
    np.random.seed(seed)
    random.seed(seed)
    try:
        for i in indices:
            q.put(Prefetcher._copy_batch(gen[i]))
    except KeyboardInterrupt:  # pragma: no cover
        pass
    except BaseException:  # carried to the consumer
        import traceback
        q.put(_PipelineError(RuntimeError(traceback.format_exc())))


class MultiprocessPrefetcher:
    """Ordered pool of worker processes (the reference's
    ``fit_generator(workers=cpu_count//2, use_multiprocessing=True)``,
    utils.py:240; JAX ``MultiprocessPrefetcher``).

    Worker ``w`` of ``W`` computes batches ``w, w+W, ...`` into its own
    bounded queue, and the consumer reads queue ``i % W`` for batch ``i``:
    the output is in order by construction, back-pressure is per worker,
    and a worker that died is reported instead of waited on.  Workers start
    anew at each iteration, so that they see the generator's current epoch
    (the parent's ``on_epoch_end`` shuffle reaches them by pickle) with the
    seeds ``seed + 977 * epoch + w``; batches cross the process boundary by
    pickle, so they are copies.

    Workers come from a forkserver, whose server process starts clean (no
    CUDA context, no threads of the training process) and imports this
    module once: forking a process that holds a CUDA context is unsafe,
    and spawning would import the package afresh in every worker of every
    epoch.  The workers use numpy and PIL, never torch.  A started worker
    would also run the imports of the parent's main script (``__main__``
    is re-imported as ``__mp_main__``, so that what it defines unpickles):
    for a training script, torch in every worker of every epoch, about 8 s
    a start on the card's host.  Unless the generator's class is defined
    in ``__main__``, the script's path is withheld while the workers
    start, and they import nothing of it."""

    _PRELOAD = ["deeplab_tpu_torch.data.generator"]

    def __init__(self, gen, workers: Optional[int] = None,
                 max_queue_size: int = 10, seed: int = 0):
        self.gen = gen
        self.workers = workers or max((os.cpu_count() or 2) // 2, 1)
        self.max_queue_size = max_queue_size
        self.seed = seed
        self._epoch = 0

    @contextlib.contextmanager
    def _main_withheld(self):
        """Hide ``__main__``'s file and spec from the workers' preparation
        data while they start (see the class docstring)."""
        main = sys.modules.get("__main__")
        if main is None or type(self.gen).__module__ == "__main__":
            yield
            return
        saved = {k: main.__dict__[k] for k in ("__file__", "__spec__")
                 if k in main.__dict__}
        main.__dict__.pop("__file__", None)
        main.__spec__ = None
        try:
            yield
        finally:
            main.__dict__.pop("__spec__", None)
            main.__dict__.update(saved)

    def _start(self, n: int, w: int):
        import multiprocessing as mp
        try:
            ctx = mp.get_context("forkserver")
            # before the server's first start: every later worker forks
            # with this module already imported (a no-op afterwards)
            ctx.set_forkserver_preload(self._PRELOAD)
        except ValueError:  # pragma: no cover - no forkserver here
            ctx = mp.get_context("spawn")
        per_q = max(1, self.max_queue_size // w)
        queues, procs = [], []
        with self._main_withheld():
            for wi in range(w):
                q = ctx.Queue(maxsize=per_q)
                p = ctx.Process(target=_mp_worker,
                                args=(self.gen, range(wi, n, w), q,
                                      (self.seed + 977 * self._epoch + wi)
                                      % (2 ** 31)),
                                daemon=True)
                p.start()
                queues.append(q)
                procs.append(p)
        return queues, procs

    def __iter__(self):
        n = len(self.gen)
        w = max(1, min(self.workers, n))
        queues, procs = self._start(n, w)
        self._epoch += 1
        try:
            for i in range(n):
                q, p = queues[i % w], procs[i % w]
                while True:
                    try:
                        item = q.get(timeout=5.0)
                        break
                    except queue.Empty:
                        # only a timeout: anything else (an unpickling
                        # error) propagates rather than shifting the order
                        if not p.is_alive() and q.empty():
                            raise RuntimeError(
                                f"data pipeline worker {i % w} died "
                                f"(exitcode {p.exitcode})") from None
                if isinstance(item, _PipelineError):
                    raise RuntimeError(
                        "data pipeline worker failed") from item.exc
                yield item
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)

    def close(self):
        pass
