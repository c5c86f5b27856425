"""Training on one GPU (deeplab_tpu/train): Trainer, callbacks, optimizer."""

from deeplab_tpu_torch.train.callbacks import (Callback, EarlyStopping,
                                               JSONLLogger, ReduceLROnPlateau)
from deeplab_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer", "Callback", "EarlyStopping", "JSONLLogger",
           "ReduceLROnPlateau"]
