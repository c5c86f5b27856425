"""SegNet (deeplab_tpu/models/seg_model.py): the DeepLabV3+ graph with a
MobileNetV2 or Xception trunk, truncated where the reference's SegModel
truncates it (models/deeplabv3p.py), then one of two heads:

- ``'original'``: the 1x1 ``conv_upsample`` to ``n_classes`` and a TF1
  bilinear resize to the input size;
- ``'subpixel'``: the 1x1 ``subpixel`` conv (bias, ICNR init) to
  ``n_classes * r^2`` channels and the reference's phase shift by
  ``r = scale`` (8 for MobileNetV2, 4 for Xception).

Every layer is a submodule named after its Keras layer, so loading weights
is a walk over names (params.py).

``SegModel`` is the reference's facade around it (JAX ``SegModel``): the
net, its weight file and the data generators.
"""

from __future__ import annotations

import os

import torch

from deeplab_tpu_torch import core
from deeplab_tpu_torch.models import deeplabv3p
from deeplab_tpu_torch.ops import init as inits
from deeplab_tpu_torch.ops.conv import Conv2D
from deeplab_tpu_torch.ops.pixel_shuffle import phase_shift
from deeplab_tpu_torch.ops.resize import resize_bilinear_tf1


class SegNet(deeplabv3p.DeepLabNet):
    """``SegNet(image_size, n_classes, backbone="mobilenetv2" | "xception",
    net="original" | "subpixel", OS=16 | 8)``.  ``OS`` is the Xception
    trunk's output stride; MobileNetV2 always runs at 8 (as in the JAX
    package).  Weights are glorot from ``torch.Generator().manual_seed(seed)``
    (ICNR for the subpixel conv) with BN at identity statistics, like a
    fresh Keras model, until params.py loads real ones.  ``fuse_blocks``
    and ``calibrating``: see :class:`~deeplabv3p.DeepLabNet`."""

    def __init__(self, image_size, n_classes: int, backbone: str = "mobilenetv2",
                 net: str = "original", OS: int = 16, alpha: float = 1.0,
                 seed: int = 0, fuse_blocks: bool = True):
        super().__init__()
        if net not in ("original", "subpixel"):
            raise ValueError(f"unknown net {net!r}")
        self.sz = tuple(image_size)
        self.n_classes = n_classes
        self.net = net
        self.scale = 4 if backbone == "xception" else 8
        c, gen = self._build_trunk(backbone, OS, alpha, seed, fuse_blocks)
        if net == "original":
            self.conv_upsample = Conv2D(c, n_classes, 1, use_bias=True,
                                        gen=gen)
        else:
            r = self.scale
            self.subpixel = Conv2D(
                c, n_classes * r * r, 1, use_bias=True, gen=gen,
                kernel_init=lambda g, shape: inits.icnr(g, shape, r))
        # channels-last memory: NHWC is the layout of the inputs and of the
        # fused kernel; 1x1 convs are then (pixels x C) products
        self.to(memory_format=torch.channels_last)

    def apply(self, img, compute_dtype="float32"):
        """(B, H, W, 3) BGR 0-255 -> (B, H*W, n) float32 softmax of the head
        logits, the forward in eval mode whatever the net's mode (JAX
        ``SegNet.apply`` with ``training=False``).  A callable argument
        keeps ``nn.Module.apply``: ``fn`` on every submodule."""
        if callable(img):
            return super().apply(img)
        was = self.training
        self.eval()
        try:
            logits = self.logits(img, compute_dtype)
        finally:
            self.train(was)
        B, H, W, n = logits.shape
        with torch.inference_mode():
            return torch.softmax(logits.float().reshape(B, H * W, n), dim=-1)

    def _logits_nchw(self, img, policy, gen=None):
        feats = deeplabv3p.deeplabv3_forward(self, img, policy, gen)
        if self.net == "subpixel":
            return phase_shift(self.subpixel(feats, policy), self.scale)
        x = self.conv_upsample(feats, policy)
        return resize_bilinear_tf1(x, self.sz, self.band)

    def apply_logits(self, img: torch.Tensor, compute_dtype="float32",
                     gen=None):
        """(B, H, W, 3) BGR 0-255 -> (B, H, W, n) head logits in the compute
        dtype, under autograd (JAX ``SegNet.apply_logits``).  In training
        mode BN uses batch statistics and updates its moving statistics,
        and dropout draws from ``gen``."""
        policy = core.resolve_compute_dtype(compute_dtype)
        with core.precision_flags(policy):
            return self._logits_nchw(img, policy, gen).permute(0, 2, 3, 1)


class SegModel:
    """Reference utils.py:160-254 facade (JAX ``SegModel``): the image size,
    the dataset folder and the batch settings, ``create_seg_model`` (a
    :class:`SegNet`, seeded, optionally loading its weight file),
    ``create_generators`` (a ``SegmentationGenerator``) and training:
    ``train_generator`` (the reference's ``fit_generator`` with its worker
    pool), ``build_callbacks`` (notebook cell 5) and ``train`` (in-memory
    arrays).  The weight file is ``weights/{backbone}_{net}.h5`` where
    ``h5py`` imports and ``.npz`` where it does not (the format a training
    run here can write, ``params.weights_suffix``); either suffix loads.
    The net trains in place: ``self.model`` holds the trained weights."""

    epochs = 20
    batch_size = 16

    def __init__(self, dataset="VOCdevkit/VOC2012", image_size=(320, 320)):
        self.sz = tuple(image_size)
        self.mainpath = dataset
        self.crop = False
        self.net = None
        self.model: SegNet = None

    def create_seg_model(self, net, n=21, backbone="mobilenetv2",
                         load_weights=False, multi_gpu=False, seed=0, OS=16,
                         alpha=1.0):
        """Build the truncated trunk and head; returns the :class:`SegNet`
        (also kept as ``self.model``).  ``seed`` takes the place of the JAX
        ``rng``."""
        from deeplab_tpu_torch.params import weights_suffix
        self.net = net
        self.modelpath = f"weights/{backbone}_{net}{weights_suffix()}"
        model = SegNet(self.sz, n, backbone, net, OS=OS, alpha=alpha,
                       seed=seed)
        if load_weights:
            self._load_h5(model, self.modelpath)
        self.model = model
        self.multi_gpu = multi_gpu
        return model

    def _load_h5(self, model, path):
        from deeplab_tpu_torch.params import load_weights
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return load_weights(path, model)

    def load_weights(self, model=None):
        """Load ``self.modelpath`` into ``model`` (by default the facade's
        net); returns the net."""
        return self._load_h5(model if model is not None else self.model,
                             self.modelpath)

    def create_generators(self, crop_shape=False, mode="train",
                          do_ahisteq=True, n_classes=21, horizontal_flip=True,
                          vertical_flip=False, blur=False, with_bg=True,
                          brightness=0.1, rotation=5.0, zoom=0.1,
                          validation_split=0.2, seed=7):
        from deeplab_tpu_torch.data.generator import SegmentationGenerator
        return SegmentationGenerator(
            folder=self.mainpath, mode=mode, n_classes=n_classes,
            do_ahisteq=do_ahisteq, batch_size=self.batch_size,
            resize_shape=self.sz[::-1], crop_shape=crop_shape,
            horizontal_flip=horizontal_flip, vertical_flip=vertical_flip,
            blur=blur, brightness=brightness, rotation=rotation, zoom=zoom,
            validation_split=validation_split, seed=seed)

    def train_generator(self, model, train_generator, valid_generator,
                        callbacks=None, mp=True, **train_kw):
        """Reference utils.py:231-241: train ``model`` on the generators
        through the ``Trainer``; returns its history.  ``mp=True`` is
        ``fit_generator``'s worker pool (utils.py:240: ``cpu_count // 2``
        worker processes); ``train_kw`` goes to the ``Trainer`` (e.g.
        ``compute_dtype``, ``device``)."""
        from deeplab_tpu_torch.train.trainer import Trainer
        if mp:
            train_kw.setdefault("workers",
                                max((os.cpu_count() or 2) // 2, 1))
            train_kw.setdefault("use_multiprocessing", True)
        trainer = Trainer(model, epochs=self.epochs,
                          callbacks=callbacks or [], **train_kw)
        history = trainer.fit(model, train_generator, valid_generator)
        self.model = model
        return history

    def build_callbacks(self, tf_board=False, plot_process=False,
                        monitor="val_Jaccard", mode="max"):
        """Notebook cell 5's callbacks: ``ModelCheckpoint`` of the best
        ``monitor`` to ``self.modelpath``, ``EarlyStopping`` (patience 100)
        and ``ReduceLROnPlateau`` (0.5, patience 5, floor 1e-6); with
        ``tf_board``, ``TensorBoard`` in place of the checkpoint."""
        from deeplab_tpu_torch.train.callbacks import (EarlyStopping,
                                                       ModelCheckpoint,
                                                       ReduceLROnPlateau,
                                                       TensorBoard)
        checkpointer = ModelCheckpoint(self.modelpath, verbose=1,
                                       save_best_only=True, monitor=monitor,
                                       mode=mode)
        stop_train = EarlyStopping(monitor=monitor, patience=100, verbose=1,
                                   mode=mode)
        reduce_lr = ReduceLROnPlateau(monitor=monitor, factor=0.5,
                                      patience=5, min_lr=1e-6)
        if tf_board:
            return [reduce_lr, stop_train,
                    TensorBoard(log_dir="./logs/" + str(self.net))]
        return [checkpointer, reduce_lr, stop_train]

    def train(self, model, X, y, val_data, tf_board=False,
              plot_train_process=False, **train_kw):
        """Reference utils.py:243-254: train on in-memory arrays
        (``ArrayBatcher``, unweighted) with :meth:`build_callbacks`;
        returns the history.  ``train_kw`` goes to the ``Trainer``."""
        from deeplab_tpu_torch.data.generator import ArrayBatcher
        from deeplab_tpu_torch.train.trainer import Trainer
        trainer = Trainer(model, epochs=self.epochs,
                          callbacks=self.build_callbacks(tf_board=tf_board),
                          **train_kw)
        gen = ArrayBatcher(X, y, self.batch_size, n_classes=model.n_classes)
        val_gen = ArrayBatcher(val_data[0], val_data[1], self.batch_size,
                               n_classes=model.n_classes)
        history = trainer.fit(model, gen, val_gen)
        self.model = model
        return history

    @classmethod
    def set_num_epochs(cls, new_epochs):
        cls.epochs = new_epochs

    @classmethod
    def set_batch_size(cls, new_batch_size):
        cls.batch_size = new_batch_size
