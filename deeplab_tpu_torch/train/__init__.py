"""Training on one GPU (deeplab_tpu/train): Trainer, callbacks, optimizer,
train-state checkpoints, BN calibration and profiling."""

from deeplab_tpu_torch.train.bn_calibrate import calibrate_bn
from deeplab_tpu_torch.train.callbacks import (Callback, EarlyStopping,
                                               JSONLLogger, ModelCheckpoint,
                                               ReduceLROnPlateau, TensorBoard)
from deeplab_tpu_torch.train.checkpoint import (restore_train_state,
                                                save_train_state)
from deeplab_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer", "Callback", "EarlyStopping", "JSONLLogger",
           "ModelCheckpoint", "ReduceLROnPlateau", "TensorBoard",
           "calibrate_bn", "save_train_state", "restore_train_state"]
