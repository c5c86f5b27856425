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

import copy
import os

import torch
from torch import nn

from deeplab_tpu_torch import core
from deeplab_tpu_torch.models import deeplabv3p
from deeplab_tpu_torch.ops import init as inits
from deeplab_tpu_torch.ops.conv import Conv2D
from deeplab_tpu_torch.ops.pixel_shuffle import phase_shift
from deeplab_tpu_torch.ops.resize import resize_bilinear_tf1


class SegNet(nn.Module):
    """``SegNet(image_size, n_classes, backbone="mobilenetv2" | "xception",
    net="original" | "subpixel", OS=16 | 8)``.  ``OS`` is the Xception
    trunk's output stride; MobileNetV2 always runs at 8 (as in the JAX
    package).  Weights are glorot from ``torch.Generator().manual_seed(seed)``
    (ICNR for the subpixel conv) with BN at identity statistics, like a
    fresh Keras model, until params.py loads real ones.

    ``fuse_blocks=False`` keeps every fused layer (MBConv block, SepConv_BN)
    on the plain layer composition (the yardstick the kernel path is
    compared with)."""

    def __init__(self, image_size, n_classes: int, backbone: str = "mobilenetv2",
                 net: str = "original", OS: int = 16, alpha: float = 1.0,
                 seed: int = 0, fuse_blocks: bool = True):
        super().__init__()
        if backbone not in ("mobilenetv2", "xception"):
            raise ValueError(f"unknown backbone {backbone!r}")
        if net not in ("original", "subpixel"):
            raise ValueError(f"unknown net {net!r}")
        self.sz = tuple(image_size)
        self.n_classes = n_classes
        self.backbone, self.net, self.OS, self.alpha = backbone, net, OS, alpha
        self.scale = 4 if backbone == "xception" else 8
        self.fuse_blocks = fuse_blocks
        gen = torch.Generator().manual_seed(seed)
        c = deeplabv3p.build(self.add_module, gen, backbone, OS, alpha)
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

    @property
    def layer_order(self):
        """Layer names in Keras graph order (JAX ``SegNet.layer_order``),
        which the freeze policy counts from."""
        return tuple(name for name, _ in self.named_children())

    def at_size(self, image_size):
        """A twin of this network at another input size (JAX
        ``SegNet.at_size``) that shares its submodules, so the same
        parameter and buffer tensors, with no copy.  The graph is fully
        convolutional: the ASPP image pool and the decoder take their
        geometry from the input, the 'original' head resizes to the twin's
        size.  Used by the Predictor's multi-scale test-time
        augmentation."""
        twin = copy.copy(self)                  # its own attribute dict
        twin._modules = dict(self._modules)     # holding the same modules
        twin.sz = tuple(image_size)
        return twin

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
        return resize_bilinear_tf1(x, self.sz)

    def apply_logits(self, img: torch.Tensor, compute_dtype="float32",
                     gen=None):
        """(B, H, W, 3) BGR 0-255 -> (B, H, W, n) head logits in the compute
        dtype, under autograd (JAX ``SegNet.apply_logits``).  In training
        mode BN uses batch statistics and updates its moving statistics,
        and dropout draws from ``gen``."""
        policy = core.resolve_compute_dtype(compute_dtype)
        with core.precision_flags(policy):
            return self._logits_nchw(img, policy, gen).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def logits(self, img: torch.Tensor, compute_dtype="float32"):
        """(B, H, W, 3) BGR 0-255 -> (B, H, W, n) head logits in the compute
        dtype (JAX ``SegNet.apply_logits``, eval mode)."""
        policy = core.resolve_compute_dtype(compute_dtype)
        with core.precision_flags(policy):
            return self._logits_nchw(img, policy).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def predict_ids(self, img: torch.Tensor, compute_dtype="float32"):
        """(B, H, W, 3) -> (B, H, W) int32 argmax of the head logits (the
        softmax is per-pixel monotone, so it is skipped)."""
        policy = core.resolve_compute_dtype(compute_dtype)
        with core.precision_flags(policy):
            logits = self._logits_nchw(img, policy)
        return torch.argmax(logits, dim=1).to(torch.int32)


_A7 = ("is not ported yet: it comes with ROADMAP A7 (train-state "
       "checkpoints, ModelCheckpoint and the card's weight-file format)")


class SegModel:
    """Reference utils.py:160-254 facade (JAX ``SegModel``): the image size,
    the dataset folder and the batch settings, ``create_seg_model`` (a
    :class:`SegNet`, seeded, optionally loading
    ``weights/{backbone}_{net}.h5``) and ``create_generators`` (a
    ``SegmentationGenerator``).  Training
    through the facade (``train_generator``, ``build_callbacks``,
    ``train``) raises ``NotImplementedError``."""

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
        self.net = net
        self.modelpath = f"weights/{backbone}_{net}.h5"
        model = SegNet(self.sz, n, backbone, net, OS=OS, alpha=alpha,
                       seed=seed)
        if load_weights:
            self._load_h5(model, self.modelpath)
        self.model = model
        self.multi_gpu = multi_gpu
        return model

    def _load_h5(self, model, path):
        from deeplab_tpu_torch.params import load_keras_h5
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return load_keras_h5(path, model)

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

    def train_generator(self, *args, **kw):
        raise NotImplementedError(f"SegModel.train_generator (its worker "
                                  f"pool and callbacks) {_A7}")

    def build_callbacks(self, *args, **kw):
        raise NotImplementedError(f"SegModel.build_callbacks (TensorBoard, "
                                  f"ModelCheckpoint) {_A7}")

    def train(self, *args, **kw):
        raise NotImplementedError(f"SegModel.train {_A7}")

    @classmethod
    def set_num_epochs(cls, new_epochs):
        cls.epochs = new_epochs

    @classmethod
    def set_batch_size(cls, new_batch_size):
        cls.batch_size = new_batch_size
