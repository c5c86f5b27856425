"""Single-GPU trainer (deeplab_tpu/train/trainer.py without the mesh).

One train step: forward in training mode (batch-statistic BN, dropout 0.1
after ASPP), the void-masked, sample-weighted CE on the head logits,
backward, a Keras-Adam update, and the step metrics.  Under the bf16 policy
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

Meshes, spatial sharding and DDP raise ``NotImplementedError``: they come
with the multi-GPU slice (A10).
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import torch
import torch.utils.checkpoint

from deeplab_tpu_torch import core
from deeplab_tpu_torch.losses import masked_sparse_ce_logits
from deeplab_tpu_torch.metrics import accuracy_from_ids, jaccard_from_ids
from deeplab_tpu_torch.ops.bn import moving_statistics
from deeplab_tpu_torch.train.optimizer import KerasAdam, freeze_set


class Trainer:
    def __init__(self, model, epochs: int = 20, callbacks: Iterable = (),
                 lr: float = 7e-4, epsilon: float = 1e-8, decay: float = 1e-6,
                 freeze_before: Optional[str] = None, mesh=None, seed: int = 0,
                 verbose: int = 1, spatial: bool = False, compute_dtype=None,
                 eval_dtype=None, remat: bool = False, workers: int = 1,
                 use_multiprocessing: bool = False, ddp: bool = False,
                 profile_dir: Optional[str] = None,
                 profile_steps: tuple = (2, 5), device=None):
        for name, asked in (("mesh", mesh is not None), ("spatial", spatial),
                            ("ddp", ddp)):
            if asked:
                raise NotImplementedError(
                    f"Trainer {name} is not ported yet: it comes with the "
                    f"multi-GPU slice (A10)")
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
        self.device = core.resolve_device(device)
        self.stop_training = False
        self.opt = None
        self.gen = None
        self.step = 0
        self.frozen = frozenset()
        self.profiler = None
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
        self.gen = torch.Generator(self.device).manual_seed(self.seed)
        net.train()

    def _put(self, X, Y, SW):
        dev = self.device
        return (torch.as_tensor(X).to(dev, torch.float32),
                torch.as_tensor(Y).to(dev), torch.as_tensor(SW).to(dev))

    @staticmethod
    def _loss_and_metrics(out, Y, SW):
        b, h, w, n = out.shape
        labels = Y[..., 0].reshape(b, h, w)
        loss = masked_sparse_ce_logits(labels, out, SW.reshape(b, h, w))
        with torch.no_grad():
            preds = out.argmax(-1).reshape(b, h * w)
            labels = labels.reshape(b, h * w)
            metrics = {"Jaccard": jaccard_from_ids(labels, preds, n),
                       "sparse_accuracy": accuracy_from_ids(labels, preds, n)}
        return loss, metrics

    # ------------------------------------------------------------- steps ----

    def _forward(self, X):
        """The training forward; under ``remat`` one checkpointed region.
        Its recompute (inside ``backward``) restarts the dropout generator
        where the forward started it and holds the BN moving statistics,
        so it replays the forward's values without a second update."""
        net, gen, policy = self.model, self.gen, self.policy
        if not self.remat:
            return net.apply_logits(X, policy, gen)
        start = gen.get_state()
        calls = [0]

        def forward(x):
            calls[0] += 1
            gen.set_state(start)
            if calls[0] == 1:
                return net.apply_logits(x, policy, gen)
            with moving_statistics(net, "hold"):
                return net.apply_logits(x, policy, gen)
        return torch.utils.checkpoint.checkpoint(forward, X,
                                                 use_reentrant=False)

    def train_step(self, X, Y, SW):
        """One step on a host or device batch; returns the step metrics as
        device tensors.  The gradients stay in ``p.grad`` until the next
        step."""
        X, Y, SW = self._put(X, Y, SW)
        with core.precision_flags(self.policy):
            out = self._forward(X)
            after = self.gen.get_state() if self.remat else None
            loss, metrics = self._loss_and_metrics(out, Y, SW)
            self.opt.zero_grad()
            loss.backward()
            if after is not None:        # where the plain step leaves it
                self.gen.set_state(after)
            self.opt.step(self.lr_scale)
        return {"loss": loss.detach(), **metrics}

    def eval_step(self, X, Y, SW):
        """Validation at ``eval_dtype`` (f32 by default: val_Jaccard drives
        the callbacks' decisions), with the moving statistics."""
        net = self.model
        X, Y, SW = self._put(X, Y, SW)
        net.eval()
        try:
            with torch.no_grad():
                out = net.logits(X, self.eval_policy)
                loss, metrics = self._loss_and_metrics(out, Y, SW)
        finally:
            net.train()
        return {"loss": loss, **metrics}

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
        from deeplab_tpu_torch.train.profiling import (StepTimer,
                                                       StepWindowProfiler)
        self.stop_training = False
        self.setup(net)
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
        timer = StepTimer()
        try:
            for epoch in range(initial_epoch, self.epochs):
                t0 = time.time()
                logs = self._epoch(pipes[0], self.train_step, timer)
                if valid_gen is not None:
                    logs.update({f"val_{k}": v for k, v in
                                 self._epoch(pipes[1], self.eval_step).items()})
                for k, v in logs.items():
                    history.setdefault(k, []).append(v)
                if self.verbose:
                    msg = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
                    print(f"Epoch {epoch + 1}/{self.epochs} "
                          f"({time.time() - t0:.1f}s, {timer.summary()}) - "
                          f"{msg}")
                train_gen.on_epoch_end()
                for cb in self.callbacks:
                    cb.on_epoch_end(epoch, logs)
                if state_checkpoint is not None:
                    self._save_state(state_checkpoint, epoch)
                if self.stop_training:
                    break
        finally:
            for pipe in pipes:
                if hasattr(pipe, "close"):
                    pipe.close()
            if self.profiler is not None:
                self.profiler.close()
        return history

    def _epoch(self, pipe, step, timer=None):
        """Run ``step`` over one pass of ``pipe``; mean of each metric (one
        host read per metric per epoch).  Train steps (with ``timer``) are
        timed and counted, and open and close the profiler's window."""
        sums, n = {}, 0
        prof = self.profiler if timer is not None else None
        for X, Y, sw in pipe:
            SW = sw["pred_mask"] if isinstance(sw, dict) else sw
            if prof is not None:
                prof.before_step(self.step)
            if timer is not None:
                timer.start()
            for k, v in step(X, Y, SW).items():
                sums[k] = sums.get(k, 0.0) + v
            if timer is not None:
                timer.stop(len(X))
                if prof is not None:
                    prof.after_step(self.step)
                self.step += 1
            n += 1
        return {k: float(v) / max(n, 1) for k, v in sums.items()}
