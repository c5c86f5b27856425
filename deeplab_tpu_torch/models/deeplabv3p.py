"""DeepLabV3+ graph (deeplab_tpu/models/deeplabv3p.py), both trunks.

Input contract: raw 0-255 float BGR, normalized in-graph to ``x/127.5 - 1``.
MobileNetV2 runs at output stride 8 and its ASPP has the image-pool and 1x1
branches; Xception runs at output stride 16 or 8, its ASPP adds three atrous
SepConv branches, and the decoder fuses the stride-4 skip.  In training,
dropout 0.1 follows ASPP, drawn from an explicit ``torch.Generator`` on the
device.

``Deeplabv3`` is the reference's public entry point (reference
deeplabv3p.py:209, JAX ``Deeplabv3``): the whole graph with its
``logits_semantic`` head and the softmax.  ``SegNet`` (seg_model.py) is the
same graph truncated before that head, with its own.  Both share
:class:`DeepLabNet`: their layers, the forward of the trunk, ASPP and
decoder, and so every kernel on that path.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from deeplab_tpu_torch import core
from deeplab_tpu_torch.core import annotate
from deeplab_tpu_torch.models import mobilenetv2, xception
from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.ops.conv import (Conv2D, build_sep_conv_bn, relu,
                                        sep_conv_bn)
from deeplab_tpu_torch.ops.resize import resize_bilinear_tf1
from deeplab_tpu_torch.parallel import spatial

DECODER_SKIP = 256  # entry block 2's channels, the decoder's stride-4 skip


def build_aspp(add, gen, cin: int, backbone: str, OS: int) -> int:
    add("image_pooling", Conv2D(cin, 256, 1, gen=gen))
    add("image_pooling_BN", BatchNorm(256, 1e-5, gen))
    add("aspp0", Conv2D(cin, 256, 1, gen=gen))
    add("aspp0_BN", BatchNorm(256, 1e-5, gen))
    branches = 2
    if backbone == "xception":
        for i, rate in enumerate(xception.rate_table(OS)[3]):
            build_sep_conv_bn(add, gen, f"aspp{i + 1}", cin, 256, rate=rate,
                              epsilon=1e-5)
        branches = 5
    add("concat_projection", Conv2D(256 * branches, 256, 1, gen=gen))
    add("concat_projection_BN", BatchNorm(256, 1e-5, gen))
    return 256


def aspp(net, x, policy, input_hw, OS: int):
    """ASPP head: image-pool branch (global mean -> 1x1 -> BN(1e-5) -> ReLU,
    broadcast back over the feature grid, which is what TF1 resize_bilinear
    from 1x1 does), the 1x1 ``aspp0`` branch and, for Xception, the three
    atrous SepConvs ``aspp1-3`` (ReLU after each BN, eps 1e-5),
    concatenated, then ``concat_projection`` + BN + ReLU.  Under a band
    the pool is the whole image's (a sum over the space group) and is
    broadcast over the band's rows."""
    feat_h = int(math.ceil(input_hw[0] / OS))
    feat_w = int(math.ceil(input_hw[1] / OS))
    if net.band is None:
        b4 = x.mean(dim=(2, 3), keepdim=True)
    else:
        b4 = spatial.image_mean(x, net.band)
        feat_h = x.shape[2]
    b4 = relu(net.image_pooling_BN(net.image_pooling(b4, policy)))
    b4 = b4.expand(b4.shape[0], b4.shape[1], feat_h, feat_w)
    b0 = relu(net.aspp0_BN(net.aspp0(x, policy)))
    branches = [b4, b0]
    if net.backbone == "xception":
        branches += [sep_conv_bn(net, x, policy, f"aspp{i}",
                                 depth_activation=True) for i in (1, 2, 3)]
    x = torch.cat(branches, dim=1)
    return relu(net.concat_projection_BN(net.concat_projection(x, policy)))


def build_decoder(add, gen) -> int:
    add("feature_projection0", Conv2D(DECODER_SKIP, 48, 1, gen=gen))
    add("feature_projection0_BN", BatchNorm(48, 1e-5, gen))
    build_sep_conv_bn(add, gen, "decoder_conv0", 256 + 48, 256, epsilon=1e-5)
    return build_sep_conv_bn(add, gen, "decoder_conv1", 256, 256,
                             epsilon=1e-5)


def decoder(net, x, skip1, policy, input_hw):
    """Xception decoder: TF1 bilinear to stride 4, the 48-channel
    projection of the skip (BN 1e-5, ReLU), concatenated after ``x`` (304
    channels), then two SepConvs with ReLU after each BN."""
    dec_hw = (int(math.ceil(input_hw[0] / 4)), int(math.ceil(input_hw[1] / 4)))
    x = resize_bilinear_tf1(x, dec_hw, net.band)
    s = relu(net.feature_projection0_BN(net.feature_projection0(skip1,
                                                                policy)))
    x = torch.cat([x, s], dim=1)
    x = sep_conv_bn(net, x, policy, "decoder_conv0", depth_activation=True)
    return sep_conv_bn(net, x, policy, "decoder_conv1", depth_activation=True)


def build(add, gen, backbone: str, OS: int, alpha: float) -> int:
    """Register the truncated graph's layers in Keras graph order; returns
    the feature channels the head takes."""
    if backbone == "xception":
        c = xception.build_backbone(add, gen, OS)
    else:
        c = mobilenetv2.build_backbone(add, gen, alpha)
    c = build_aspp(add, gen, c, backbone, OS)
    if backbone == "xception":
        c = build_decoder(add, gen)
    return c


def dropout(x, rate: float, gen, band=None):
    """Training-mode dropout (JAX ``deeplabv3p.dropout``): keep each value
    with probability ``1 - rate`` and scale it by ``1/(1 - rate)``.  Under
    ``band`` the mask is drawn over the whole map (the draws of the data
    slot's one-process forward) and the band keeps its rows."""
    keep = 1.0 - rate
    shape = x.shape
    if band is not None:
        a, b = band.rows(band.level(x.shape[2]))
        shape = (x.shape[0], x.shape[1], spatial.map_height(x, band),
                 x.shape[3])
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    if band is not None:
        mask = mask[:, :, a:b]
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def image_hw(net, img):
    """The (H, W) of the NHWC images ``img`` holds (under a band, of which
    it holds some rows)."""
    return (img.shape[1] if net.band is None else net.band.H, img.shape[2])


def deeplabv3_forward(net, img, policy, gen=None):
    """NHWC BGR 0-255 ``img`` -> NCHW features: the JAX
    ``deeplabv3_forward(..., return_features=True)``, i.e. the post-Dropout
    ASPP projection (MobileNetV2, stride 8) or the decoder's output
    (Xception, stride 4), where SegNet truncates the graph.  Dropout acts in
    training mode only, with ``gen``; in eval mode and while
    ``train/bn_calibrate.py`` runs (``net.calibrating``) it is the
    identity.  The heads are the caller's: ``SegNet``'s or
    ``Deeplabv3``'s ``logits_semantic``.  Under a band (``net.band``,
    ``parallel/spatial.py``) ``img`` holds the band's rows of the
    image.  ASPP and its dropout are the trace region ``aspp``; the
    Xception decoder, as in JAX, has no region."""
    input_hw = image_hw(net, img)
    x = img.to(policy.dtype) / 127.5 - 1.0
    x = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
    if net.backbone == "xception":
        OS = net.OS
        x, skip1 = xception.backbone(net, x, policy, OS)
    else:
        OS = 8                         # forced for this trunk
        x = mobilenetv2.backbone(net, x, policy)
    with annotate("aspp"):
        x = aspp(net, x, policy, input_hw, OS)
        if net.training and not net.calibrating:
            if gen is None:
                raise ValueError("a training forward needs a "
                                 "torch.Generator for dropout")
            x = dropout(x, 0.1, gen, band=net.band)
    if net.backbone == "xception":
        x = decoder(net, x, skip1, policy, input_hw)
    return x


class DeepLabNet(nn.Module):
    """What ``SegNet`` and ``Deeplabv3`` share: the layers in Keras graph
    order (``layer_order``, which the freeze policy counts from), twins at
    other input sizes, and eval-mode logits and labels.  A subclass builds
    its head and defines ``_logits_nchw(img, policy, gen)``.

    ``fuse_blocks=False`` keeps every fused layer (MBConv block, SepConv_BN)
    on the plain layer composition.  ``calibrating`` is set by
    ``train/bn_calibrate.py`` for its forwards: training-mode BN (batch
    statistics), no dropout, no fused block."""

    calibrating = False
    band = None          # set by parallel/spatial.py's ``banded``

    def _build_trunk(self, backbone: str, OS: int, alpha: float, seed: int,
                     fuse_blocks: bool):
        if backbone not in ("mobilenetv2", "xception"):
            raise ValueError(f"unknown backbone {backbone!r}")
        self.backbone, self.OS, self.alpha = backbone, OS, alpha
        self.fuse_blocks = fuse_blocks
        gen = torch.Generator().manual_seed(seed)
        return build(self.add_module, gen, backbone, OS, alpha), gen

    @property
    def layer_order(self):
        """Layer names in Keras graph order (JAX ``layer_order``)."""
        return tuple(name for name, _ in self.named_children())

    def at_size(self, image_size):
        """A twin of this network at another input size (JAX ``at_size``)
        that shares its submodules, so the same parameter and buffer
        tensors, with no copy.  The graph is fully convolutional: the ASPP
        image pool and the decoder take their geometry from the input.
        Used by the Predictor's multi-scale test-time augmentation."""
        twin = copy.copy(self)                  # its own attribute dict
        twin._modules = dict(self._modules)     # holding the same modules
        twin.sz = tuple(image_size)
        return twin

    @torch.inference_mode()
    def logits(self, img: torch.Tensor, compute_dtype="float32"):
        """(B, H, W, 3) BGR 0-255 -> (B, H, W, n) head logits in the compute
        dtype (JAX ``apply_logits``, eval mode)."""
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


class Deeplabv3(DeepLabNet):
    """``Deeplabv3(weights=None | "pascal_voc", input_tensor=None,
    infer=False, input_shape=(512, 512, 3), classes=21,
    backbone="mobilenetv2" | "xception", OS=16, alpha=1.0)``, the reference's
    entry point (JAX ``Deeplabv3``): the full graph, ending in the 1x1
    ``logits_semantic`` conv (``custom_logits_semantic`` when ``classes`` is
    not 21), a TF1 bilinear resize to the input size and the softmax.

    :meth:`apply` returns probabilities, (B, H, W, C) with ``infer`` and
    (B, H*W, C) without.  ``weights="pascal_voc"`` loads the release
    weights from a local file (``params.load_pretrained_pascal_voc``; no
    download).  Weights are otherwise glorot from ``seed``, BN at identity
    statistics.  It has no ``apply_logits``: the Trainer trains it on its
    probabilities with ``losses.masked_sparse_ce``, as JAX does.
    ``input_tensor`` is accepted for the reference's signature and
    ignored."""

    def __init__(self, weights=None, input_tensor=None, infer: bool = False,
                 input_shape=(512, 512, 3), classes: int = 21,
                 backbone: str = "mobilenetv2", OS: int = 16,
                 alpha: float = 1.0, seed: int = 0,
                 fuse_blocks: bool = True):
        if weights not in {"pascal_voc", None}:
            raise ValueError("weights must be 'pascal_voc' or None")
        if backbone not in {"xception", "mobilenetv2"}:
            raise ValueError("backbone must be 'xception' or 'mobilenetv2'")
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.sz = self.input_shape[:2]
        self.infer = infer
        self.classes = self.n_classes = classes
        self.weights = weights
        c, gen = self._build_trunk(backbone, OS, alpha, seed, fuse_blocks)
        self.head_name = ("logits_semantic" if classes == 21
                          else "custom_logits_semantic")
        self.add_module(self.head_name, Conv2D(c, classes, 1, use_bias=True,
                                               gen=gen))
        self.to(memory_format=torch.channels_last)
        if weights == "pascal_voc":
            from deeplab_tpu_torch.params import load_pretrained_pascal_voc
            load_pretrained_pascal_voc(self, backbone)

    def _logits_nchw(self, img, policy, gen=None):
        feats = deeplabv3_forward(self, img, policy, gen)
        with annotate("head"):          # JAX deeplabv3p.py's "head" scope
            x = getattr(self, self.head_name)(feats, policy)
            return resize_bilinear_tf1(x, image_hw(self, img), self.band)

    def apply(self, img, compute_dtype="float32", training: bool = False,
              gen=None, infer=None):
        """(B, H, W, 3) BGR 0-255 -> float32 softmax probabilities (JAX
        ``Deeplabv3.apply``).  ``training=False``: the eval-mode forward
        (moving statistics, no dropout) without autograd.  ``training=
        True``: the training forward under autograd (batch-statistic BN
        that updates its moving statistics, dropout from ``gen``).  A
        callable argument keeps ``nn.Module.apply``: ``fn`` on every
        submodule."""
        if callable(img):
            return super().apply(img)
        policy = core.resolve_compute_dtype(compute_dtype)
        was = self.training
        self.train(training)
        try:
            with torch.inference_mode(not training), \
                    core.precision_flags(policy):
                x = self._logits_nchw(img, policy, gen)
        finally:
            self.train(was)
        probs = torch.softmax(x.float().permute(0, 2, 3, 1), dim=-1)
        if self.infer if infer is None else infer:
            return probs
        B, H, W, C = probs.shape
        return probs.reshape(B, H * W, C)
