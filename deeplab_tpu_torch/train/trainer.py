"""Trainer (deeplab_tpu/train/trainer.py).

One train step: forward in training mode (batch-statistic BN, dropout 0.1
after ASPP), the void-masked, sample-weighted CE on the head logits (on
the softmax probabilities, ``losses.masked_sparse_ce``, for a net without
``apply_logits``: the reference's ``Deeplabv3``), backward, a Keras-Adam
update, and the step metrics.  Under the bf16 policy
the 14 stride-1 expand blocks of a MobileNetV2 net run forward and backward
through ``kernels/fused_mbconv_train``; params, grads and the optimizer stay
f32.  Xception nets and the subpixel head train through the plain layer
composition (``fused_sepconv`` is eval-only, as in JAX).  Step metrics
accumulate on the device and are read once per epoch, so no step waits for
the host.

``fit`` also writes and restores whole train-state checkpoints
(``train/checkpoint.py``, with the callbacks' state), traces a window of
steps (``profile_dir``, ``train/profiling.py``), feeds the steps from a
thread or an ordered pool of worker processes (``workers``,
``use_multiprocessing``) and can rematerialize the forward in the backward
(``remat``, ``torch.utils.checkpoint``).  Under remat the recompute
replays the forward with the step's dropout draws and no BN momentum
update, so a remat step equals a plain one; the training blocks' forward
phases F1-F3 then launch twice a step (28 each) and B2 and B34 once (14).

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``: the process group,
one process per device, each fed its local rows as JAX's processes are):

- ``Trainer(mesh=...)`` is JAX's SPMD step.  BN normalizes with the global
  batch's statistics (all-reduced under autograd); the loss is the global
  Keras-weighted mean and the gradients, the loss and the metrics' sums
  are all-reduced.  Over more than one process the MBConv blocks take the
  plain composition, as JAX's multi-device SPMD step does; over one, the
  kernels.
- ``Trainer(mesh=..., ddp=True)`` is JAX's ``ddp_train_step``: BN on each
  process's local statistics, the kernels per process, the same global
  loss and all-reduces, and the moving statistics averaged.

In both, dropout comes from a generator seeded with the data index folded
in (JAX's SPMD step draws one mask over the global batch: the same
distribution, other draws).

- ``Trainer(mesh=get_mesh(space=S), spatial=True)`` is JAX's SPMD step
  with the image height sharded over the mesh's 'space' axis
  (``parallel/spatial.py``).  Each process takes its data slot's whole
  images and keeps its band's rows of ``X``, ``Y`` and ``SW``; the net
  exchanges the rows its convs and resizes read across bands.  BN
  normalizes over the whole mesh (each pixel once); the image pool's BN,
  whose input the space group shares, over the data axis (each image
  once).  The loss, the gradients and the pixel accuracy sum over the
  mesh; the per-image Jaccard sums each image's counts over the space
  group first.  Every space process of a data slot draws the slot's
  dropout mask over the whole map.  Without a mesh, or with ``space ==
  1``, ``spatial=True`` is the plain step, as in JAX.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from deeplab_tpu_torch import core
from deeplab_tpu_torch.core import annotate
from deeplab_tpu_torch.losses import (
    sparse_crossentropy_ignoring_last_label,
    sparse_logits_crossentropy_ignoring_last_label)
from deeplab_tpu_torch.metrics import (accuracy_sums_from_ids,
                                       jaccard_counts_from_ids,
                                       jaccard_from_sums,
                                       jaccard_sums_from_counts)
from deeplab_tpu_torch.ops.bn import BatchNorm, moving_statistics
from deeplab_tpu_torch.parallel import spatial as SP
from deeplab_tpu_torch.parallel.mesh import Mesh, get_mesh, is_coordinator
from deeplab_tpu_torch.train.optimizer import KerasAdam, freeze_set


def fold_seed(seed: int, rank: int) -> int:
    """The dropout seed of data slot ``rank``: ``seed`` itself on slot 0
    (so a one-process mesh draws as the plain Trainer does), a distinct
    63-bit value on the others."""
    if rank == 0:
        return seed
    return (seed * 6364136223846793005 + rank * 1442695040888963407) % (
        1 << 63)


def _served_batch_sizes(gen):
    """The distinct batch sizes ``gen`` serves this epoch, from its
    metadata where it has them (JAX ``_served_batch_sizes``): both
    generators slice ``[i*bs:(i+1)*bs]`` out of n samples."""
    bs = getattr(gen, "batch_size", None)
    n = None
    for attr in ("image_path_list", "X"):
        src = getattr(gen, attr, None)
        if src is not None:
            n = len(src)
            break
    if bs is not None and n is not None and len(gen) > 0:
        return sorted({min(bs, n), min(bs, n - (len(gen) - 1) * bs)})
    return [len(gen[0][0])] if len(gen) else []


class Trainer:
    def __init__(self, model, epochs: int = 20, callbacks: Iterable = (),
                 lr: float = 7e-4, epsilon: float = 1e-8, decay: float = 1e-6,
                 freeze_before: Optional[str] = None, mesh=None, seed: int = 0,
                 verbose: int = 1, spatial: bool = False, compute_dtype=None,
                 eval_dtype=None, remat: bool = False, workers: int = 1,
                 use_multiprocessing: bool = False, ddp: bool = False,
                 profile_dir: Optional[str] = None,
                 profile_steps: tuple = (2, 5), device=None):
        if ddp and spatial:
            raise ValueError("ddp=True is data-parallel only; it cannot be "
                             "combined with spatial=True")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a deeplab_tpu_torch.parallel.mesh"
                            ".Mesh (get_mesh())")
        if ddp and mesh is None:           # the default group, or one process
            mesh = get_mesh(device=device)
        self.mesh = mesh
        self.ddp = ddp
        # height sharding only where a data slot has several processes
        self.spatial = bool(spatial and mesh is not None and mesh.space > 1)
        self.model = model
        self.epochs = epochs
        self.callbacks = list(callbacks)
        self.base_lr = lr
        self.lr_scale = 1.0
        self.decay = decay
        self.epsilon = epsilon
        self.freeze_before = freeze_before
        self.seed = seed
        self.verbose = verbose
        self.policy = core.resolve_compute_dtype(compute_dtype
                                                 or torch.float32)
        self.eval_policy = core.resolve_compute_dtype(eval_dtype
                                                      or torch.float32)
        self.remat = remat
        # the host pipeline (reference fit_generator, utils.py:240): 0 loads
        # in the step loop, 1 (or more without use_multiprocessing) on a
        # thread, more with use_multiprocessing on an ordered process pool
        self.workers = workers
        self.use_multiprocessing = use_multiprocessing
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self.device = (mesh.device if mesh is not None and device is None
                       else core.resolve_device(device))
        self.stop_training = False
        self.opt = None
        self.gen = None
        self.step = 0
        self.frozen = frozenset()
        self.profiler = None
        self._sizes = None
        for cb in self.callbacks:
            cb.set_trainer(self)

    def current_lr(self) -> float:
        return self.base_lr * self.lr_scale

    # ------------------------------------------------------------ set-up ----

    def setup(self, net):
        """Move ``net`` to the device, apply the freeze policy (frozen
        layers: no gradient, BN on its moving statistics), build the
        optimizer over the trainable parameters and seed the dropout
        generator.  ``fit`` calls it; a caller that drives
        :meth:`train_step` itself calls it once first."""
        self.model = net.to(self.device)
        self.fused = hasattr(net, "apply_logits")
        self.frozen = freeze_set(net.layer_order, self.freeze_before,
                                 order=net.layer_order)
        for name, mod in net.named_children():
            frozen = name in self.frozen
            mod.frozen = frozen
            for p in mod.parameters():
                p.requires_grad_(not frozen)
        self.opt = KerasAdam(
            [p for p in net.parameters() if p.requires_grad],
            self.base_lr, self.epsilon, self.decay)
        mesh = self.mesh
        slot = mesh.data_index if mesh is not None else 0
        self.gen = torch.Generator(self.device).manual_seed(
            fold_seed(self.seed, slot))
        # the SPMD mode over several processes: BN over the global batch
        sync = mesh if (mesh is not None and not self.ddp
                        and mesh.world > 1) else None
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.group = sync
        pool_bn = getattr(net, "image_pooling_BN", None)
        if self.spatial and pool_bn is not None:
            # its input is the whole image's pool, the same on every space
            # process of a slot: each image once
            pool_bn.group = mesh.data_axis()
        net.train()

    def _put(self, X, Y, SW):
        dev = self.device
        return (torch.as_tensor(X).to(dev, torch.float32),
                torch.as_tensor(Y).to(dev), torch.as_tensor(SW).to(dev))

    def _band(self, X, Y, SW):
        """Under spatial sharding: this process's band of the images ``X``
        (B, H, W, 3), and its rows of ``Y`` (B, H*W, 1) and ``SW`` (B,
        H*W); else None and the batch.  The space processes of a data
        slot must hold the same images (``ValueError`` otherwise)."""
        if not self.spatial:
            return None, X, Y, SW
        b, H, W = X.shape[:3]
        band = SP.Band.of(self.mesh, H, SP.unit_of(self.model))
        SP.check_same_images(self.mesh, X, Y)
        rows = lambda t: band.take(t.reshape((b, H, W) + t.shape[2:])
                                   ).reshape((b, -1) + t.shape[2:])
        return band, band.take(X), rows(Y), rows(SW)

    def _all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_sum(t) if self.mesh is not None else t

    def _loss(self, out, Y, SW):
        """The loss part of this process, ``sum(ce * sw) / count`` with the
        nonzero-weight count over every process (the Keras temporal-weight
        mean of the global batch once the parts are summed; one process:
        ``losses.weighted_loss``).  ``out``: (B, H, W, n) logits, or
        probabilities of any shape (B, ..., n) for a net without
        ``apply_logits``."""
        b, n = out.shape[0], out.shape[-1]
        labels = Y[..., 0].reshape(b, -1)
        sw = SW.reshape(b, -1)
        out = out.reshape(b, -1, n)
        if self.fused:
            per_px = sparse_logits_crossentropy_ignoring_last_label(labels,
                                                                    out)
        else:
            per_px = sparse_crossentropy_ignoring_last_label(labels[..., None],
                                                             out)
        num = torch.sum(per_px * sw)
        with torch.no_grad():
            den = self._all_sum(torch.sum((sw != 0).to(per_px.dtype)))
        return num / torch.clamp(den, min=1.0)

    @torch.no_grad()
    def _metrics(self, out, Y):
        """The step metrics of ``out`` (as :meth:`_loss` takes it) from the
        sums over every process."""
        b, n = out.shape[0], out.shape[-1]
        labels = Y[..., 0].reshape(b, -1)
        preds = out.reshape(b, -1, n).argmax(-1)
        correct, legal = accuracy_sums_from_ids(labels, preds, n)
        counts = jaccard_counts_from_ids(labels, preds, n)
        if self.mesh is not None:
            # each image's counts over its bands (the identity at space 1),
            # then its IoU; the sums over the data axis
            flat = self.mesh.space_sum(torch.cat(
                [torch.cat(counts, dim=1).reshape(-1), correct[None],
                 legal[None]]))
            counts = flat[:-2].reshape(b, 3 * n).split(n, dim=1)
            correct, legal = flat[-2], flat[-1]
        iou_sum, n_legal = jaccard_sums_from_counts(*counts)
        if self.mesh is not None:
            flat = self.mesh.data_axis().all_sum(torch.cat(
                [iou_sum, n_legal, correct[None], legal[None]]))
            iou_sum, n_legal = flat[:n], flat[n:2 * n]
            correct, legal = flat[2 * n], flat[2 * n + 1]
        return {"Jaccard": jaccard_from_sums(iou_sum, n_legal),
                "sparse_accuracy": correct / torch.clamp(legal, min=1.0)}

    def _reduce_grads(self):
        """Sum every trainable gradient over the processes (one
        all-reduce of their concatenation)."""
        if self.mesh is None:
            return
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        if not grads:
            return
        flat = self._all_sum(torch.cat([g.reshape(-1) for g in grads]))
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()

    def _average_moving_statistics(self):
        """The ddp mode's moving statistics: each process's update
        averaged over the processes (JAX ``pmean`` of the state)."""
        bufs = list(self.model.buffers())
        flat = self._all_sum(torch.cat([b.reshape(-1) for b in bufs]))
        flat /= self.mesh.world
        i = 0
        with torch.no_grad():
            for b in bufs:
                b.copy_(flat[i:i + b.numel()].view_as(b))
                i += b.numel()

    # ------------------------------------------------------------- steps ----

    def _forward(self, X):
        """The training forward; under ``remat`` one checkpointed region.
        Its recompute (inside ``backward``) restarts the dropout generator
        where the forward started it and holds the BN moving statistics,
        so it replays the forward's values without a second update."""
        net, gen, policy = self.model, self.gen, self.policy
        if self.fused:
            apply = lambda x: net.apply_logits(x, policy, gen)
        else:
            apply = lambda x: net.apply(x, policy, training=True, gen=gen)
        if not self.remat:
            return apply(X)
        start = gen.get_state()
        calls = [0]

        def forward(x):
            calls[0] += 1
            gen.set_state(start)
            if calls[0] == 1:
                return apply(x)
            with moving_statistics(net, "hold"):
                return apply(x)
        return torch.utils.checkpoint.checkpoint(forward, X,
                                                 use_reentrant=False)

    def train_step(self, X, Y, SW):
        """One step on a host or device batch; returns the step metrics as
        device tensors.  The gradients stay in ``p.grad`` until the next
        step.  The trace regions ``loss``, ``optimizer`` (the update with
        its lr scaling) and ``step_metrics`` are the JAX step's, in its
        order; the step is the span ``train_step``, and ``train.put`` (the
        batch to the device), ``train.forward`` and ``train.backward`` (the
        gradients and their reduction) are the port's."""
        with annotate("train_step"):
            with annotate("train.put"):
                batch = self._put(X, Y, SW)
            band, X, Y, SW = self._band(*batch)
            with core.precision_flags(self.policy), \
                    SP.banded(self.model, band):
                with annotate("train.forward"):
                    out = self._forward(X)
                after = self.gen.get_state() if self.remat else None
                with annotate("loss"):
                    loss = self._loss(out, Y, SW)
                with annotate("train.backward"):
                    self.opt.zero_grad()
                    loss.backward()
                    if after is not None:    # where the plain step leaves it
                        self.gen.set_state(after)
                    self._reduce_grads()
                with annotate("optimizer"):
                    self.opt.step(self.lr_scale)
                with annotate("step_metrics"):
                    metrics = self._metrics(out.detach(), Y)
            if self.ddp and self.mesh is not None:
                self._average_moving_statistics()
            return {"loss": self._all_sum(loss.detach()), **metrics}

    def eval_step(self, X, Y, SW):
        """Validation at ``eval_dtype`` (f32 by default: val_Jaccard drives
        the callbacks' decisions), with the moving statistics."""
        net = self.model
        band, X, Y, SW = self._band(*self._put(X, Y, SW))
        net.eval()
        try:
            with torch.no_grad(), SP.banded(net, band):
                out = (net.logits(X, self.eval_policy) if self.fused
                       else net.apply(X, self.eval_policy))
                loss = self._loss(out, Y, SW)
                metrics = self._metrics(out, Y)
        finally:
            net.train()
        return {"loss": self._all_sum(loss), **metrics}

    # --------------------------------------------------------------- fit ----

    def _pipeline(self, gen):
        """The host pipeline over ``gen``, built once a fit so that the
        process pool's per-epoch reseed advances."""
        from deeplab_tpu_torch.data.generator import (MultiprocessPrefetcher,
                                                      Prefetcher)
        if self.workers > 1 and self.use_multiprocessing:
            return MultiprocessPrefetcher(gen, workers=self.workers,
                                          seed=self.seed)
        if self.workers >= 1:
            return Prefetcher(gen)

        class _Sync:
            def __iter__(_s):
                for i in range(len(gen)):
                    yield gen[i]
        return _Sync()

    def _resume(self, path: str, initial_epoch: int) -> int:
        """Restore the train state and the callbacks' state from ``path``;
        returns the epoch to start at.  Callback states are matched by
        class name, each to the first unmatched callback of that class, so
        that a changed callback list cannot apply one's counters to
        another."""
        from deeplab_tpu_torch.train.checkpoint import restore_train_state
        self.step, self.lr_scale, extra = restore_train_state(
            path, self.model, self.opt, self.gen)
        initial_epoch = max(initial_epoch, extra.get("epoch", 0))
        unmatched = list(self.callbacks)
        for name, cb_state in extra.get("callbacks", []):
            for cb in unmatched:
                if type(cb).__name__ == name:
                    cb.set_state(cb_state)
                    unmatched.remove(cb)
                    break
        if self.verbose:
            print(f"resumed from {path} (epoch {initial_epoch}, step "
                  f"{self.step})")
        return initial_epoch

    def _save_state(self, path: str, epoch: int):
        from deeplab_tpu_torch.train.checkpoint import save_train_state
        save_train_state(
            path, self.model, self.opt, self.step, self.lr_scale,
            extra={"epoch": epoch + 1,
                   "callbacks": [[type(cb).__name__, cb.get_state()]
                                 for cb in self.callbacks]},
            generator=self.gen)

    def fit(self, net, train_gen, valid_gen=None, initial_epoch: int = 0,
            state_checkpoint: Optional[str] = None,
            resume_from: Optional[str] = None):
        """Train ``net`` in place on ``train_gen``; returns the history
        (loss, Jaccard, sparse_accuracy and, with ``valid_gen``, their
        ``val_`` twins, one value per epoch).  ``state_checkpoint``: write
        the whole train state there after each epoch's callbacks.
        ``resume_from``: where that file exists, continue from it (its
        epoch, optimizer, dropout generator and callbacks' state)."""
        from deeplab_tpu_torch.train.profiling import StepWindowProfiler
        self.stop_training = False
        self.setup(net)
        self._agree_batch_sizes(train_gen, valid_gen)
        self.step = 0
        if resume_from is not None and os.path.exists(resume_from):
            initial_epoch = self._resume(resume_from, initial_epoch)
        history = {"loss": [], "Jaccard": [], "sparse_accuracy": []}
        if valid_gen is not None:
            history.update({"val_loss": [], "val_Jaccard": [],
                            "val_sparse_accuracy": []})
        pipes = [self._pipeline(train_gen)]
        if valid_gen is not None:
            pipes.append(self._pipeline(valid_gen))
        self.profiler = (StepWindowProfiler(self.profile_dir,
                                            *self.profile_steps)
                         if self.profile_dir is not None else None)
        try:
            for epoch in range(initial_epoch, self.epochs):
                t0 = time.perf_counter()
                logs, steps, items = self._epoch(pipes[0], self.train_step,
                                                 train=True)
                train_s = time.perf_counter() - t0
                if valid_gen is not None:
                    logs.update({f"val_{k}": v for k, v in
                                 self._epoch(pipes[1],
                                             self.eval_step)[0].items()})
                for k, v in logs.items():
                    history.setdefault(k, []).append(v)
                if self.verbose:
                    # steps run asynchronously and the training pass ends in
                    # the host read of its metrics: only its whole time
                    # gives a true rate
                    msg = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
                    print(f"Epoch {epoch + 1}/{self.epochs} "
                          f"({time.perf_counter() - t0:.1f}s, "
                          f"{1e3 * train_s / max(steps, 1):.1f} ms/step, "
                          f"{items / train_s:.1f} items/s) - {msg}")
                train_gen.on_epoch_end()
                for cb in self.callbacks:
                    cb.on_epoch_end(epoch, logs)
                if state_checkpoint is not None and is_coordinator():
                    self._save_state(state_checkpoint, epoch)
                if self.stop_training:
                    break
        finally:
            for m in net.modules():
                if isinstance(m, BatchNorm):
                    m.group = None
            for pipe in pipes:
                if hasattr(pipe, "close"):
                    pipe.close()
            if self.profiler is not None:
                self.profiler.close()
        return history

    def _epoch(self, pipe, step, train: bool = False):
        """Run ``step`` over one pass of ``pipe``; returns the mean of
        each metric (one host read per metric per epoch, which waits for
        the epoch's last step), the steps and the images.  Train steps
        (``train``) are counted and open and close the profiler's
        window."""
        sums, n, items = {}, 0, 0
        prof = self.profiler if train else None
        for X, Y, sw in pipe:
            SW = sw["pred_mask"] if isinstance(sw, dict) else sw
            self._check_batch_divides(X)
            if prof is not None:
                prof.before_step(self.step)
            for k, v in step(X, Y, SW).items():
                sums[k] = sums.get(k, 0.0) + v
            if train:
                if prof is not None:
                    prof.after_step(self.step)
                self.step += 1
            n += 1
            items += len(X)
        return ({k: float(v) / max(n, 1) for k, v in sums.items()}, n,
                items)

    # ------------------------------------------------- data parallelism ----

    def _agree_batch_sizes(self, train_gen, valid_gen):
        """Over a mesh of several processes, every process must serve the
        same number of batches of the same sizes, or the collectives of
        the steps would pair up the wrong calls (JAX's global batch is
        the local rows times the data count).  Checked once a fit
        from each generator's metadata; raises ``ValueError``."""
        self._sizes = None
        if self.mesh is None or self.mesh.world == 1:
            return
        import torch.distributed as dist
        mine = [(len(g), _served_batch_sizes(g)) if g is not None else None
                for g in (train_gen, valid_gen)]
        every = [None] * self.mesh.world
        dist.all_gather_object(every, mine, group=self.mesh.group)
        if any(o != mine for o in every):
            raise ValueError(
                f"the processes serve different batches (batches, sizes) "
                f"per (train, validation) generator: {every}; give every "
                f"process the same number of rows (generator host_id/"
                f"num_hosts shards, a batch size that divides them)")
        self._sizes = {s for m in mine if m for s in m[1]}

    def _check_batch_divides(self, X):
        """JAX ``_check_batch_divides``: each process's batch must divide
        its share of the mesh's data axis (each process holds its data
        slot's whole images here, so a nonempty batch) and, over several
        processes, be one of the sizes every process agreed on
        (:meth:`_agree_batch_sizes`)."""
        n = len(X)
        if n == 0 or (self._sizes is not None and n not in self._sizes):
            world = self.mesh.data if self.mesh is not None else 1
            raise ValueError(
                f"local batch of {n} rows does not match this process's "
                f"share of the mesh ({world} data slots, each process "
                f"holding its slot's images; "
                f"agreed sizes {sorted(self._sizes or [])}): make every "
                f"process's batches, the final one included, the same "
                f"nonempty size")

    @torch.no_grad()
    def predict(self, X, batch_size: int = 16):
        """Batched float32 inference (JAX ``Trainer.predict``): the eval-
        mode probabilities of ``X`` (this process's rows; each process runs
        its own on its own device), (N, H*W, n) as a numpy array.  Under
        spatial sharding each space process runs its band and returns its
        data slot's whole rows."""
        net = self.model.to(self.device)
        outs = []
        for i in range(0, len(X), batch_size):
            xb = torch.as_tensor(X[i:i + batch_size]).to(self.device,
                                                          torch.float32)
            band = None
            if self.spatial:
                band = SP.Band.of(self.mesh, xb.shape[1], SP.unit_of(net))
                xb = band.take(xb)
            with SP.banded(net, band):
                probs = net.apply(xb)
            if band is not None:           # the rows of every band
                b, n = xb.shape[0], probs.shape[-1]
                probs = band.gather(probs.reshape(b, -1, xb.shape[2], n))
                probs = probs.reshape(b, -1, n)
            outs.append(probs.cpu().numpy())
        return np.concatenate(outs, axis=0)
