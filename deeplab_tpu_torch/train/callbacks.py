"""Training-control callbacks (deeplab_tpu/train/callbacks.py): LR-on-plateau
halving, early stopping and a JSONL epoch log.  Host-side epoch-boundary
logic; the step sees them only through the Trainer's ``lr_scale`` and
``stop_training``.  ``ModelCheckpoint`` writes Keras h5 and waits for a
weight format the GPU machine can write (it has no ``h5py``).
"""

from __future__ import annotations

import json
import os

import numpy as np


class Callback:
    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_epoch_end(self, epoch: int, logs: dict):
        pass


class _MonitorCallback(Callback):
    """Shared monitor/best/wait bookkeeping."""

    def __init__(self, monitor: str, mode: str):
        self.monitor = monitor
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.wait = 0

    def _improved(self, value: float) -> bool:
        return value > self.best if self.mode == "max" else value < self.best


class ReduceLROnPlateau(_MonitorCallback):
    """Reference: factor=0.5, patience=5, min_lr=1e-6 on val_Jaccard."""

    def __init__(self, monitor: str = "val_Jaccard", factor: float = 0.5,
                 patience: int = 5, min_lr: float = 1e-6, mode: str = "max",
                 verbose: int = 0):
        super().__init__(monitor, mode)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.verbose = verbose

    def on_epoch_end(self, epoch: int, logs: dict):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            if self.trainer.current_lr() > self.min_lr:
                self.trainer.lr_scale = max(
                    self.trainer.lr_scale * self.factor,
                    self.min_lr / self.trainer.base_lr)
                if self.verbose:
                    print(f"epoch {epoch}: reducing lr to "
                          f"{self.trainer.current_lr():.2e}")
            self.wait = 0


class EarlyStopping(_MonitorCallback):
    """Reference: patience=100 on val_Jaccard (mode max)."""

    def __init__(self, monitor: str = "val_Jaccard", patience: int = 100,
                 mode: str = "max", verbose: int = 0):
        super().__init__(monitor, mode)
        self.patience = patience
        self.verbose = verbose

    def on_epoch_end(self, epoch: int, logs: dict):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.trainer.stop_training = True
            if self.verbose:
                print(f"epoch {epoch}: early stopping")


class JSONLLogger(Callback):
    """Append one JSON object per epoch to ``path``."""

    def __init__(self, path: str):
        self.path = path

    def on_epoch_end(self, epoch: int, logs: dict):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps({"epoch": epoch,
                                "lr": self.trainer.current_lr(), **logs})
                    + "\n")
