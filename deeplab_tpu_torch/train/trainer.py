"""Single-GPU trainer (deeplab_tpu/train/trainer.py without the mesh).

One train step: forward in training mode (batch-statistic BN, dropout 0.1
after ASPP), the void-masked, sample-weighted CE on the head logits,
backward, a Keras-Adam update, and the step metrics.  Under the bf16 policy
the 14 stride-1 expand blocks run forward and backward through
``kernels/fused_mbconv_train``; params, grads and the optimizer stay f32.
Step metrics accumulate on the device and are read once per epoch, so no
step waits for the host.

Meshes, spatial sharding, DDP, remat, profiling, train-state checkpoints,
multiprocess workers and training an Xception or subpixel net raise
``NotImplementedError`` and name their slice.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import torch

from deeplab_tpu_torch import core
from deeplab_tpu_torch.losses import masked_sparse_ce_logits
from deeplab_tpu_torch.metrics import accuracy_from_ids, jaccard_from_ids
from deeplab_tpu_torch.train.optimizer import KerasAdam, freeze_set

_LATER = "is not ported yet: it comes with {}"


class Trainer:
    def __init__(self, model, epochs: int = 20, callbacks: Iterable = (),
                 lr: float = 7e-4, epsilon: float = 1e-8, decay: float = 1e-6,
                 freeze_before: Optional[str] = None, mesh=None, seed: int = 0,
                 verbose: int = 1, spatial: bool = False, compute_dtype=None,
                 eval_dtype=None, remat: bool = False, workers: int = 1,
                 use_multiprocessing: bool = False, ddp: bool = False,
                 profile_dir: Optional[str] = None, device=None):
        later = {"mesh": (mesh is not None, "the multi-GPU slice (A10)"),
                 "spatial": (spatial, "the multi-GPU slice (A10)"),
                 "ddp": (ddp, "the multi-GPU slice (A10)"),
                 "remat": (remat, "the rest of the training slice (A7)"),
                 "profile_dir": (profile_dir is not None,
                                 "the rest of the training slice (A7)"),
                 "multiprocess workers": (workers > 1 or use_multiprocessing,
                                          "the data slice "
                                          "(SegmentationGenerator, A7)"),
                 "for an Xception or subpixel net": (
                     (getattr(model, "backbone", "mobilenetv2"),
                      getattr(model, "net", "original"))
                     != ("mobilenetv2", "original"),
                     "the training half of the Xception and subpixel "
                     "slice (A8)")}
        for name, (asked, where) in later.items():
            if asked:
                raise NotImplementedError(f"Trainer {name} "
                                          + _LATER.format(where))
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
        self.workers = workers
        self.device = core.resolve_device(device)
        self.stop_training = False
        self.opt = None
        self.gen = None
        self.frozen = frozenset()
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

    def train_step(self, X, Y, SW):
        """One step on a host or device batch; returns the step metrics as
        device tensors.  The gradients stay in ``p.grad`` until the next
        step."""
        net = self.model
        X, Y, SW = self._put(X, Y, SW)
        with core.precision_flags(self.policy):
            out = net.apply_logits(X, self.policy, self.gen)
            loss, metrics = self._loss_and_metrics(out, Y, SW)
            self.opt.zero_grad()
            loss.backward()
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
        if self.workers >= 1:
            from deeplab_tpu_torch.data.generator import Prefetcher
            return Prefetcher(gen)

        class _Sync:
            def __iter__(_s):
                for i in range(len(gen)):
                    yield gen[i]
        return _Sync()

    def fit(self, net, train_gen, valid_gen=None, initial_epoch: int = 0,
            state_checkpoint: Optional[str] = None,
            resume_from: Optional[str] = None):
        """Train ``net`` in place on ``train_gen``; returns the history
        (loss, Jaccard, sparse_accuracy and, with ``valid_gen``, their
        ``val_`` twins, one value per epoch)."""
        if state_checkpoint is not None or resume_from is not None:
            raise NotImplementedError(
                "train-state checkpoints " + _LATER.format(
                    "the rest of the training slice (train/checkpoint.py)"))
        self.stop_training = False
        self.setup(net)
        history = {"loss": [], "Jaccard": [], "sparse_accuracy": []}
        if valid_gen is not None:
            history.update({"val_loss": [], "val_Jaccard": [],
                            "val_sparse_accuracy": []})
        pipes = [self._pipeline(train_gen)]
        if valid_gen is not None:
            pipes.append(self._pipeline(valid_gen))
        try:
            for epoch in range(initial_epoch, self.epochs):
                t0 = time.time()
                logs = self._epoch(pipes[0], self.train_step)
                if valid_gen is not None:
                    logs.update({f"val_{k}": v for k, v in
                                 self._epoch(pipes[1], self.eval_step).items()})
                for k, v in logs.items():
                    history.setdefault(k, []).append(v)
                if self.verbose:
                    msg = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
                    print(f"Epoch {epoch + 1}/{self.epochs} "
                          f"({time.time() - t0:.1f}s) - {msg}")
                train_gen.on_epoch_end()
                for cb in self.callbacks:
                    cb.on_epoch_end(epoch, logs)
                if self.stop_training:
                    break
        finally:
            for pipe in pipes:
                if hasattr(pipe, "close"):
                    pipe.close()
        return history

    @staticmethod
    def _epoch(pipe, step):
        """Run ``step`` over one pass of ``pipe``; mean of each metric (one
        host read per metric per epoch)."""
        sums, n = {}, 0
        for X, Y, sw in pipe:
            SW = sw["pred_mask"] if isinstance(sw, dict) else sw
            for k, v in step(X, Y, SW).items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        return {k: float(v) / max(n, 1) for k, v in sums.items()}
