"""Training-control callbacks (deeplab_tpu/train/callbacks.py): best-weights
checkpointing, LR-on-plateau halving, early stopping, a JSONL epoch log and
TensorBoard scalars.  Host-side epoch-boundary logic; the step sees them
only through the Trainer's ``lr_scale`` and ``stop_training``.  Over a
data-parallel mesh every process runs them and only the coordinator
(rank 0) writes files.  The
monitoring callbacks carry their best value and wait count across a resume
(``get_state``/``set_state``, saved in the train-state checkpoint).
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

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict):
        pass


class _MonitorCallback(Callback):
    """Shared monitor/best/wait bookkeeping, and the state a resume
    restores."""

    def __init__(self, monitor: str, mode: str):
        self.monitor = monitor
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.wait = 0

    def _improved(self, value: float) -> bool:
        return value > self.best if self.mode == "max" else value < self.best

    def get_state(self) -> dict:
        return {"best": float(self.best), "wait": int(self.wait)}

    def set_state(self, state: dict):
        self.best = float(state.get("best", self.best))
        self.wait = int(state.get("wait", self.wait))


class ModelCheckpoint(_MonitorCallback):
    """Reference notebook cell 5: save the weights of the best epoch on
    ``monitor`` (``save_best_only``), or after every epoch whatever the
    monitor (Keras semantics of ``save_best_only=False``).  The path's
    suffix picks the format: ``.npz`` through ``params.save_npz`` (numpy
    only, what a machine without ``h5py`` can write), anything else a
    Keras-2 h5 through ``params.save_keras_h5``.  An h5 path where ``h5py``
    does not import raises here, at construction, never in the middle of
    training."""

    def __init__(self, filepath: str, monitor: str = "val_Jaccard",
                 mode: str = "max", save_best_only: bool = True,
                 verbose: int = 0):
        super().__init__(monitor, mode)
        from deeplab_tpu_torch.params import h5_available
        if not filepath.endswith(".npz") and not h5_available():
            raise ImportError(
                f"ModelCheckpoint({filepath!r}) writes Keras h5, which needs "
                f"h5py, and h5py does not import here: give a path ending in "
                f"'.npz' ({os.path.splitext(filepath)[0]}.npz) for the "
                f"numpy-only weight file")
        self.filepath = filepath
        self.save_best_only = save_best_only
        self.verbose = verbose

    def _save(self, epoch, value):
        # every process runs the monitor (the metrics are all-reduced, so
        # they decide alike) but only the coordinator writes
        from deeplab_tpu_torch.parallel.mesh import is_coordinator
        if not is_coordinator():
            return
        from deeplab_tpu_torch import params as P
        net = self.trainer.model
        if self.filepath.endswith(".npz"):
            P.save_npz(self.filepath, net)
        else:
            P.save_keras_h5(self.filepath, net)
        if self.verbose:
            tag = "" if value is None else f" ({self.monitor}={value:.4f})"
            print(f"epoch {epoch}: saved {self.filepath}{tag}")

    def on_epoch_end(self, epoch: int, logs: dict):
        value = logs.get(self.monitor)
        if not self.save_best_only:
            self._save(epoch, value)
            return
        if value is None:
            print(f"warning: can save best model only with {self.monitor} "
                  f"available, skipping (have: {sorted(logs)})")
            return
        if self._improved(value):
            self.best = value
            self._save(epoch, value)


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
        from deeplab_tpu_torch.parallel.mesh import is_coordinator
        if not is_coordinator():
            return     # one writer a job
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps({"epoch": epoch,
                                "lr": self.trainer.current_lr(), **logs})
                    + "\n")


class TensorBoard(Callback):
    """Reference notebook cell 5 (``TensorBoard(log_dir='./logs/'+net)``):
    each epoch's logs and ``lr`` as scalars, through
    ``torch.utils.tensorboard`` where its ``tensorboard`` package imports; a
    no-op where it does not (as the JAX callback is without TensorFlow)."""

    def __init__(self, log_dir: str = "./logs"):
        self.log_dir = log_dir
        self._writer = None

    def _get_writer(self):
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._writer = False
            else:
                self._writer = SummaryWriter(self.log_dir)
        return self._writer

    def on_epoch_end(self, epoch: int, logs: dict):
        from deeplab_tpu_torch.parallel.mesh import is_coordinator
        if not is_coordinator():
            return     # one event file a job
        writer = self._get_writer()
        if not writer:
            return
        for k, v in logs.items():
            writer.add_scalar(k, float(v), epoch)
        writer.add_scalar("lr", self.trainer.current_lr(), epoch)
        writer.flush()
