"""DeepLabV3+ graph (deeplab_tpu/models/deeplabv3p.py), both trunks.

Input contract: raw 0-255 float BGR, normalized in-graph to ``x/127.5 - 1``.
MobileNetV2 runs at output stride 8 and its ASPP has the image-pool and 1x1
branches; Xception runs at output stride 16 or 8, its ASPP adds three atrous
SepConv branches, and the decoder fuses the stride-4 skip.  In training,
dropout 0.1 follows ASPP, drawn from an explicit ``torch.Generator`` on the
device.
"""

from __future__ import annotations

import math

import torch

from deeplab_tpu_torch.models import mobilenetv2, xception
from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.ops.conv import (Conv2D, build_sep_conv_bn, relu,
                                        sep_conv_bn)
from deeplab_tpu_torch.ops.resize import resize_bilinear_tf1

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
    concatenated, then ``concat_projection`` + BN + ReLU."""
    feat_h = int(math.ceil(input_hw[0] / OS))
    feat_w = int(math.ceil(input_hw[1] / OS))
    b4 = x.mean(dim=(2, 3), keepdim=True)
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
    x = resize_bilinear_tf1(x, dec_hw)
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


def dropout(x, rate: float, gen):
    """Training-mode dropout (JAX ``deeplabv3p.dropout``): keep each value
    with probability ``1 - rate`` and scale it by ``1/(1 - rate)``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def deeplabv3_forward(net, img, policy, gen=None):
    """NHWC BGR 0-255 ``img`` -> NCHW features: the JAX
    ``deeplabv3_forward(..., return_features=True)``, i.e. the post-Dropout
    ASPP projection (MobileNetV2, stride 8) or the decoder's output
    (Xception, stride 4), where SegNet truncates the graph.  Dropout acts in
    training mode only, with ``gen``; in eval mode it is the identity.  The
    21-class ``logits_semantic`` head is not ported."""
    input_hw = (img.shape[1], img.shape[2])
    x = img.to(policy.dtype) / 127.5 - 1.0
    x = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
    if net.backbone == "xception":
        OS = net.OS
        x, skip1 = xception.backbone(net, x, policy, OS)
    else:
        OS = 8                         # forced for this trunk
        x = mobilenetv2.backbone(net, x, policy)
    x = aspp(net, x, policy, input_hw, OS)
    if net.training:
        if gen is None:
            raise ValueError("a training forward needs a torch.Generator "
                             "for dropout")
        x = dropout(x, 0.1, gen)
    if net.backbone == "xception":
        x = decoder(net, x, skip1, policy, input_hw)
    return x
