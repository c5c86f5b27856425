"""DeepLabV3+ graph, MobileNetV2 branch (deeplab_tpu/models/deeplabv3p.py).

Input contract: raw 0-255 float BGR, normalized in-graph to ``x/127.5 - 1``.
In training, dropout 0.1 follows ASPP, drawn from an explicit
``torch.Generator`` on the device.  The Xception trunk, its three atrous
SepConv ASPP branches and the decoder are a later slice.
"""

from __future__ import annotations

import math

import torch

from deeplab_tpu_torch.models import mobilenetv2
from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.ops.conv import Conv2D


def build_aspp(add, gen, cin: int) -> int:
    add("image_pooling", Conv2D(cin, 256, 1, gen=gen))
    add("image_pooling_BN", BatchNorm(256, 1e-5, gen))
    add("aspp0", Conv2D(cin, 256, 1, gen=gen))
    add("aspp0_BN", BatchNorm(256, 1e-5, gen))
    add("concat_projection", Conv2D(512, 256, 1, gen=gen))
    add("concat_projection_BN", BatchNorm(256, 1e-5, gen))
    return 256


def aspp(net, x, policy, input_hw):
    """ASPP head, MobileNetV2 branch: image-pool branch (global mean -> 1x1 ->
    BN(1e-5) -> ReLU, broadcast back over the feature grid, which is what TF1
    resize_bilinear from 1x1 does) and the 1x1 ``aspp0`` branch, concatenated,
    then ``concat_projection`` + BN + ReLU."""
    # MobileNetV2 runs at output stride 8 (forced by the reference)
    feat_h = int(math.ceil(input_hw[0] / 8))
    feat_w = int(math.ceil(input_hw[1] / 8))
    b4 = x.mean(dim=(2, 3), keepdim=True)
    b4 = torch.relu(net.image_pooling_BN(net.image_pooling(b4, policy)))
    b4 = b4.expand(b4.shape[0], b4.shape[1], feat_h, feat_w)
    b0 = torch.relu(net.aspp0_BN(net.aspp0(x, policy)))
    x = torch.cat([b4, b0], dim=1)
    return torch.relu(net.concat_projection_BN(
        net.concat_projection(x, policy)))


def dropout(x, rate: float, gen):
    """Training-mode dropout (JAX ``deeplabv3p.dropout``): keep each value
    with probability ``1 - rate`` and scale it by ``1/(1 - rate)``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def deeplabv3_forward(net, img, policy, gen=None):
    """NHWC BGR 0-255 ``img`` -> NCHW features at output stride 8: the JAX
    ``deeplabv3_forward(..., return_features=True)``, i.e. the post-Dropout
    ASPP projection where SegNet truncates the graph.  Dropout acts in
    training mode only, with ``gen``; in eval mode it is the identity.  The
    21-class ``logits_semantic`` head is not ported."""
    input_hw = (img.shape[1], img.shape[2])
    x = img.to(policy.dtype) / 127.5 - 1.0
    x = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
    x = mobilenetv2.backbone(net, x, policy)
    x = aspp(net, x, policy, input_hw)
    if net.training:
        if gen is None:
            raise ValueError("a training forward needs a torch.Generator "
                             "for dropout")
        x = dropout(x, 0.1, gen)
    return x
