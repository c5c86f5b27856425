"""Serving API: images -> model -> argmax -> dense CRF
(deeplab_tpu/predictor.py), with multi-scale and flip test-time
augmentation and streamed file serving (``predict_files``).

With a ``mesh`` (``parallel/mesh.py``: the process group, one process per
device) each process serves its own images on its own device and returns
its own masks; JAX's data-parallel serving shards one batch the same way.

On the card, images given as a host array cross to the device through a
page-locked buffer the Predictor keeps per (shape, dtype): staged in
chunks of about ``_CHUNK_BYTES`` along the batch by torch's parallel CPU
copy, each chunk's DMA issued as soon as it is staged, so staging the next
chunk overlaps it.  Narrower dtypes (uint8) cross as they are and are
widened on the device; wider ones are rounded to float32 while staged, as
``.to(float32)`` rounds them.  The labels come back through pinned buffers
too, then one parallel host copy into fresh arrays the caller owns; with
``return_raw`` the model's labels leave on a side stream right after the
argmax, during the CRF.  Device tensors and a CPU Predictor take the direct
copies.  ``Predictor.copy_stats()`` counts what the copies did.
With ``spatial=True`` over a mesh whose data slots hold several processes
(``get_mesh(space=S)``) the ``S`` processes of a slot are given the slot's
whole images and each runs the net on one band of their rows
(``parallel/spatial.py``); the raw labels are gathered over the slot, and
the CRF runs on whole images: spread over the slot's processes when its
batch divides by ``S`` (as JAX spreads it over both mesh axes), else on
each.  Every process of the slot returns the slot's masks.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from deeplab_tpu_torch import core
from deeplab_tpu_torch.core import annotate
from deeplab_tpu_torch.crf import dense_crf
from deeplab_tpu_torch.ops.resize import resize_bilinear_tf1
from deeplab_tpu_torch.parallel import spatial as SP


# Bytes staged a chunk, so a B=1 512x512 float32 image (3.1 MB) is one
# chunk and a B=16 batch pipelines in four.  Each chunk costs the host about
# 0.1 ms (a DMA to issue, the copy threads to wake; more under a profiler)
# against the last chunk's DMA that it shortens: on an H100's host 2 MB
# chunks staged a B=16 batch in 1.5x the time 16 MB ones took.
_CHUNK_BYTES = 16 << 20


def _chunk_items(shape, itemsize: int) -> int:
    """Leading-axis items a staging chunk holds: as many as fit in
    ``_CHUNK_BYTES``, at least one."""
    per = itemsize * math.prod(shape[1:])
    return max(1, _CHUNK_BYTES // max(1, per))


class _Landing:
    """Labels on their way to the host: a device-to-host copy into the
    pinned buffer ``buf``, finished when ``done`` has completed."""

    __slots__ = ("buf", "done")

    def __init__(self, buf, done):
        self.buf, self.done = buf, done


def _resize_nhwc(x: torch.Tensor, size) -> torch.Tensor:
    """TF1 bilinear resize of an NHWC tensor (the port's resize takes
    NCHW), contiguous NHWC out."""
    y = resize_bilinear_tf1(x.permute(0, 3, 1, 2), size)
    return y.permute(0, 2, 3, 1).contiguous()


class Predictor:
    """``Predictor(net, crf=None, compute_dtype="mixed", device=None)``.

    ``net``: a :class:`~deeplab_tpu_torch.models.seg_model.SegNet` with its
    weights; it is moved to ``device`` and put in eval mode.  ``device``
    defaults to the card and raises if there is none.  ``compute_dtype``:
    ``"mixed"`` (the serving policy), ``"float32"`` or ``"bfloat16"``.
    ``crf``: a :class:`~deeplab_tpu_torch.crf.CrfConfig` refines the argmax
    on the device (``crf.PRODUCTION_CONFIG`` is the production path), or
    None.  ``n_classes`` defaults to the net's.  ``return_raw`` (with a
    CRF) returns ``(raw, refined)`` from one model forward.

    ``mesh``: a ``parallel.mesh.Mesh``; the net runs on its device (this
    process's), on this process's images.  ``spatial``: over a mesh with
    ``space > 1``, on this process's band of its data slot's images (the
    module docstring); without a mesh, or with ``space == 1``, the plain
    path, as in JAX.

    ``tta_scales`` / ``tta_flip``: multi-scale and horizontal-flip
    test-time augmentation (the upstream DeepLab evaluation protocol): the
    float32 softmax is averaged over every (scale, flip) before the argmax
    and the CRF.  Scaled sizes snap to multiples of 8, scales that snap to
    one size run once, and scale 1.0 reuses ``net`` itself; the other sizes
    run ``net.at_size`` twins, which share its weights."""

    def __init__(self, net, crf=None, compute_dtype="mixed", device=None,
                 mesh=None, n_classes=None, spatial: bool = False,
                 return_raw: bool = False, tta_scales=None,
                 tta_flip: bool = False):
        tta = bool(tta_scales) or tta_flip
        if tta and spatial:
            raise ValueError("TTA is incompatible with spatial sharding "
                             "(per-scale resizes would cross the sharded "
                             "height axis)")
        from deeplab_tpu_torch.parallel.mesh import Mesh
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a deeplab_tpu_torch.parallel.mesh"
                            ".Mesh (get_mesh())")
        self.crf = crf
        self.mesh = mesh
        self.spatial = bool(spatial and mesh is not None and mesh.space > 1)
        self.return_raw = return_raw and crf is not None
        self.n_classes = n_classes or getattr(net, "n_classes", 21)
        self.device = (mesh.device if mesh is not None and device is None
                       else core.resolve_device(device))
        self.policy = core.resolve_compute_dtype(compute_dtype)
        self.net = net.to(self.device).eval()
        self.twins = None
        if tta:
            h, w = net.sz
            self.twins, seen = [], set()
            for s in (tuple(tta_scales) if tta_scales else (1.0,)):
                hs = max(8, int(round(h * s / 8.0)) * 8)
                ws = max(8, int(round(w * s / 8.0)) * 8)
                if (hs, ws) in seen:   # scales that snap to the same size
                    continue           # would double-weight that forward
                seen.add((hs, ws))
                self.twins.append(self.net if (hs, ws) == (h, w)
                                  else self.net.at_size((hs, ws)))
            self.flips = (False, True) if tta_flip else (False,)
        # Pinned buffers by (shape, dtype), each free one with the event of
        # its last DMA (None when it has none pending); the side stream of
        # the early label copies; the copy counters (copy_stats).
        self._pinned = {}
        self._side = None
        self._lock = threading.Lock()
        self._counts = {"calls": 0, "staged_in": 0, "staged_out": 0,
                        "bytes_in": 0, "bytes_out": 0, "chunks_in": 0}

    def copy_stats(self) -> dict:
        """The copy counters since the Predictor was built: ``calls``
        (pipelines enqueued), ``staged_in`` (calls whose images crossed
        through the pinned staging), ``staged_out`` (label fetches through
        pinned buffers), ``bytes_in`` / ``bytes_out`` (bytes those staged
        copies moved each way) and ``chunks_in`` (staged chunks)."""
        with self._lock:
            return dict(self._counts)

    def _count(self, **inc):
        with self._lock:
            for k, v in inc.items():
                self._counts[k] += v

    def _take(self, shape, dtype):
        """A pinned buffer of ``shape``/``dtype`` from the Predictor's own,
        once its last DMA has finished; a new one on first use (a normal
        tensor even inside inference mode, so later calls can write it)."""
        free = self._pinned.setdefault((tuple(shape), dtype), [])
        try:
            buf, done = free.pop()
        except IndexError:
            with torch.inference_mode(False):
                return torch.empty(shape, dtype=dtype, pin_memory=True)
        if done is not None:
            done.synchronize()
        return buf

    def _give(self, buf, done=None):
        self._pinned[(tuple(buf.shape), buf.dtype)].append((buf, done))

    def _copy_in(self, images):
        """images -> a float32 tensor on the device.  A host array bound
        for the card is staged through a pinned buffer in chunks, each
        chunk's DMA enqueued on the current stream as soon as it is staged;
        the model's launches follow it in stream order.  Anything else is
        copied directly."""
        self._count(calls=1)
        on_host = not (isinstance(images, torch.Tensor)
                       and images.device.type != "cpu")
        if self.device.type != "cuda" or not on_host:
            return torch.as_tensor(images).to(self.device, torch.float32)
        src = torch.as_tensor(images)
        dt = src.dtype if src.element_size() < 4 else torch.float32
        buf = self._take(src.shape, dt)
        dev = torch.empty(src.shape, dtype=dt, device=self.device)
        step = _chunk_items(src.shape, buf.element_size())
        chunks = 0
        for i in range(0, len(src), step):
            part = buf[i:i + step]
            part.copy_(src[i:i + step])
            dev[i:i + step].copy_(part, non_blocking=True)
            chunks += 1
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._give(buf, done)
        self._count(staged_in=1, bytes_in=buf.nbytes, chunks_in=chunks)
        return dev.to(torch.float32)

    def _send_out(self, labels, side: bool = False):
        """Enqueue the device-to-host copy of ``labels`` into a pinned
        buffer: on the current stream, or (``side``) on the side stream,
        after what the current stream has enqueued so far.  On the CPU the
        labels themselves."""
        if self.device.type != "cuda":
            return labels
        buf = self._take(labels.shape, labels.dtype)
        stream = torch.cuda.current_stream(self.device)
        if side:
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            self._side.wait_stream(stream)
            labels.record_stream(self._side)
            stream = self._side
        with torch.cuda.stream(stream):
            buf.copy_(labels, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return _Landing(buf, done)

    def _land(self, sent, n=None):
        """The first ``n`` (all) items of sent labels as a fresh numpy array
        the caller owns: one parallel host copy out of the pinned buffer
        once its copy has finished, the buffer kept for the next call.
        (numpy's allocation: torch's fresh host tensors of this size fault
        in their pages anew on every call on some hosts.)"""
        if not isinstance(sent, _Landing):
            return sent[:n].cpu().numpy()
        sent.done.synchronize()
        src = sent.buf[:n]
        out = np.empty(tuple(src.shape), dtype=src.numpy().dtype)
        torch.from_numpy(out).copy_(src)
        self._give(sent.buf)
        return out

    def _fetch(self, out, n=None):
        """Labels from :meth:`_run` (a tensor, a sent copy, or a pair of
        them) -> numpy arrays of their first ``n`` items: every copy is
        enqueued before the first is waited on."""
        outs = out if isinstance(out, tuple) else (out,)
        sent = [o if isinstance(o, _Landing) else self._send_out(o)
                for o in outs]
        if self.device.type == "cuda":
            self._count(staged_out=1,
                        bytes_out=sum(s.buf.nbytes for s in sent))
        got = tuple(self._land(s, n) for s in sent)
        return got if isinstance(out, tuple) else got[0]

    def _model_preds(self, img):
        """(B, H, W) int32 labels of the model: the argmax of the head
        logits, or of the test-time augmentation's summed probabilities."""
        if self.twins is None:
            return self.net.predict_ids(img, self.policy)
        return torch.argmax(self._tta_probs(img), dim=-1).to(torch.int32)

    def _tta_probs(self, img):
        """(B, H, W, n) float32: the softmax summed over every (scale,
        flip) in order, each variant resized back to the net's size."""
        b, (h, w), n = img.shape[0], self.net.sz, self.n_classes
        acc = torch.zeros((b, h, w, n), dtype=torch.float32,
                          device=img.device)
        for m in self.twins:
            im_s = img if m.sz == (h, w) else _resize_nhwc(img, m.sz)
            for flip in self.flips:
                x = im_s.flip(2) if flip else im_s
                probs = m.apply(x, self.policy).reshape((b,) + m.sz + (n,))
                if flip:
                    probs = probs.flip(2)
                if m.sz != (h, w):
                    probs = _resize_nhwc(probs, (h, w))
                acc = acc + probs
        return acc

    def _band_preds(self, img):
        """The raw labels of the data slot's images ``img``, this process
        running its band and the bands gathered over the slot."""
        band = SP.Band.of(self.mesh, img.shape[1], SP.unit_of(self.net))
        with SP.banded(self.net, band):
            raw = self.net.predict_ids(band.take(img), self.policy)
        return band.gather(raw)

    def _crf(self, img, raw):
        """The CRF on whole images (it sees the raw 0-255 image, as in the
        JAX pipeline); under spatial sharding each space process refines
        its share of the slot's images where the batch divides, and the
        masks are gathered."""
        refine = lambda i, r: dense_crf.mean_field_batched(
            i, r, self.crf, self.n_classes)
        m = self.mesh
        if not self.spatial or img.shape[0] % m.space:
            return refine(img, raw)
        per = img.shape[0] // m.space
        mine = slice(m.space_index * per, (m.space_index + 1) * per)
        return m.space_gather(refine(img[mine], raw[mine]))

    def _run(self, images):
        """Enqueue the pipeline on the device; returns the labels for
        :meth:`_fetch` (a ``(raw, refined)`` pair with ``return_raw``)
        without waiting (under spatial sharding the gathers wait for the
        slot's processes).  Spans: ``predict.copy_in`` (the images to the
        device), ``predict.model``, with ``return_raw`` a
        ``predict.copy_out`` (on the card the model's labels leave on the
        side stream, overlapping the CRF), and ``predict.crf``."""
        with annotate("predict.copy_in"):
            img = self._copy_in(images)
        with torch.inference_mode():
            with annotate("predict.model"):
                raw = (self._band_preds(img) if self.spatial
                       else self._model_preds(img))
            if self.crf is None:
                return raw
            sent = raw
            if self.return_raw:
                with annotate("predict.copy_out"):
                    sent = self._send_out(raw, side=True)
            with annotate("predict.crf"):
                preds = self._crf(img, raw)
        return (sent, preds) if self.return_raw else preds

    def __call__(self, images):
        """images: (B, H, W, 3) raw 0-255 BGR (numpy or tensor) -> (B, H, W)
        int32 label maps as a numpy array, CRF-refined when configured; with
        ``return_raw`` a ``(raw, refined)`` pair of them.  The arrays are
        the caller's: no later call writes them.  Under a profiler the call
        is the span ``predict``, the label copies back
        ``predict.copy_out``."""
        with annotate("predict"):
            out = self._run(images)
            with annotate("predict.copy_out"):
                return self._fetch(out)

    def predict_files(self, paths, batch_size: int = 16, workers: int = 4):
        """Stream image files through the pipeline, overlapping host decode
        with device compute: a thread pool decodes and resizes the next
        batches (BGR, bilinear to the model size) while the device runs the
        current one, and results are fetched one batch behind the dispatch.
        Every batch is padded to ``batch_size`` (by repeating its last
        image), so the device sees one shape.

        Yields ``(path, mask)`` pairs in input order (``(path, (raw,
        refined))`` with ``return_raw``)."""
        import collections
        from concurrent.futures import ThreadPoolExecutor
        from deeplab_tpu_torch.data.augment import resize_bilinear
        from deeplab_tpu_torch.data.generator import _imread_bgr

        paths = list(paths)
        workers = max(1, workers)
        h, w = self.net.sz
        batches = [paths[i:i + batch_size]
                   for i in range(0, len(paths), batch_size)]

        def load_batch(bp):
            return np.stack([resize_bilinear(_imread_bgr(p), (w, h))
                             for p in bp]).astype(np.float32)

        def dispatch(X):
            pad = batch_size - X.shape[0]
            if pad:
                X = np.concatenate([X, np.repeat(X[-1:], pad, axis=0)])
            return self._run(X)

        def emit(bp, out):
            with annotate("predict.copy_out"):
                got = self._fetch(out, len(bp))
            if self.return_raw:
                raw, ref = got
                for i, p in enumerate(bp):
                    yield p, (raw[i], ref[i])
            else:
                for i, p in enumerate(bp):
                    yield p, got[i]

        with ThreadPoolExecutor(max_workers=workers) as ex:
            decoding = collections.deque()
            inflight = collections.deque()
            bi = 0
            while bi < len(batches) or decoding or inflight:
                while bi < len(batches) and len(decoding) < workers:
                    decoding.append((batches[bi],
                                     ex.submit(load_batch, batches[bi])))
                    bi += 1
                if decoding:
                    bp, fut = decoding.popleft()
                    inflight.append((bp, dispatch(fut.result())))
                drained = bi >= len(batches) and not decoding
                while inflight and (len(inflight) > 2 or drained):
                    yield from emit(*inflight.popleft())
