"""MobileNetV2 backbone for DeepLabV3+ (deeplab_tpu/models/mobilenetv2.py).

17 inverted-residual blocks at output stride 8: blocks 7-12 run at rate 2
and 14-16 at rate 4 instead of striding.  Layer names match the Keras graph
exactly (the weight contract), as submodule names of the network.  Every BN
of the trunk has eps 1e-3 and momentum 0.999.

The 14 stride-1 blocks with an expand conv (ids 2, 4-16) take a fused path:
``fused_mbconv`` in eval mode, ``fused_mbconv_train.block_train`` in bf16
training (each behind the JAX package's gate).  Block 0 (expansion 1, no
expand conv) runs its depthwise -> BN -> relu6 through ``fused_dw_bn_relu6``
in eval mode under the same policies; its project conv and BN stay the
composition.  The JAX package leaves that kernel unwired.

Under a band of the image's rows (``parallel/spatial.py``) the serving
kernels run on the band extended by the block's halo, the gate reading the
whole map's height, and the extra rows are cropped.
"""

from __future__ import annotations

import torch

from deeplab_tpu_torch.core import annotate
from deeplab_tpu_torch.kernels import fused_dw as FDW
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
from deeplab_tpu_torch.ops.bn import BatchNorm, bn_scale_shift
from deeplab_tpu_torch.ops.conv import Conv2D, DepthwiseConv2D, relu6
from deeplab_tpu_torch.parallel import spatial


def make_divisible(v, divisor, min_value=None):
    """Reference _make_divisible."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (filters, stride, expansion, block_id, skip, rate)
BLOCK_TABLE = (
    (16, 1, 1, 0, False, 1),
    (24, 2, 6, 1, False, 1),
    (24, 1, 6, 2, True, 1),
    (32, 2, 6, 3, False, 1),
    (32, 1, 6, 4, True, 1),
    (32, 1, 6, 5, True, 1),
    (64, 1, 6, 6, False, 1),   # stride changed 2->1 in the DeepLab variant
    (64, 1, 6, 7, True, 2),
    (64, 1, 6, 8, True, 2),
    (64, 1, 6, 9, True, 2),
    (96, 1, 6, 10, False, 2),
    (96, 1, 6, 11, True, 2),
    (96, 1, 6, 12, True, 2),
    (160, 1, 6, 13, False, 2),
    (160, 1, 6, 14, True, 4),
    (160, 1, 6, 15, True, 4),
    (320, 1, 6, 16, False, 4),
)


def _prefix(block_id: int) -> str:
    return f"expanded_conv_{block_id}_" if block_id else "expanded_conv_"


def build_backbone(add, gen, alpha: float = 1.0) -> int:
    """Register the trunk's layers through ``add(name, module)``; returns the
    output channel count."""
    c = make_divisible(32 * alpha, 8)
    add("Conv", Conv2D(3, c, 3, stride=2, gen=gen))
    bn = lambda ch: BatchNorm(ch, 1e-3, gen, momentum=0.999)
    add("Conv_BN", bn(c))
    for filters, stride, expansion, block_id, _, rate in BLOCK_TABLE:
        p = _prefix(block_id)
        ce = c
        if block_id:
            ce = expansion * c
            add(p + "expand", Conv2D(c, ce, 1, gen=gen))
            add(p + "expand_BN", bn(ce))
        add(p + "depthwise", DepthwiseConv2D(ce, 3, stride, rate, gen=gen))
        add(p + "depthwise_BN", bn(ce))
        c = make_divisible(int(filters * alpha), 8)
        add(p + "project", Conv2D(ce, c, 1, gen=gen))
        add(p + "project_BN", bn(c))
    return c


def _use_fused_block(net, x, policy, stride: int, block_id: int) -> bool:
    """The fused kernel serves eval-mode stride-1 blocks with an expand conv
    under the bf16 and "mixed" policies, at heights divisible by 8 (the JAX
    gate's conditions).  On a CUDA tensor the block then runs the kernel; on a
    CPU tensor its plain version.  The float32 policy keeps the composition."""
    return bool(net.fuse_blocks and block_id and stride == 1
                and not net.training
                and (policy.dtype == torch.bfloat16
                     or (policy.dtype == torch.float32 and policy.mxu_bf16))
                and spatial.map_height(x, getattr(net, "band", None))
                % 8 == 0)


def _use_fused_dw(net, policy, stride: int, block_id: int) -> bool:
    """Block 0's depthwise -> BN -> relu6 runs ``fused_dw_bn_relu6`` in eval
    mode under the bf16 and "mixed" policies (the conditions of
    :func:`_use_fused_block`; the kernel takes any map size).  float32,
    training and ``fuse_blocks=False`` keep the composition."""
    return bool(net.fuse_blocks and block_id == 0 and stride == 1
                and not net.training
                and (policy.dtype == torch.bfloat16
                     or (policy.dtype == torch.float32 and policy.mxu_bf16)))


def fused_dw_apply(net, x, prefix: str, rate: int, policy):
    """``relu6(BN(depthwise(x)))`` of block ``prefix`` through
    :func:`fused_dw_bn_relu6`, the eval BN folded with its own eps
    (``bn_scale_shift``, as ``fold_block`` folds it).  ``x`` is NCHW; the
    result is NCHW in channels-last memory."""
    scale, shift = bn_scale_shift(getattr(net, prefix + "depthwise_BN"))
    kd = getattr(net, prefix + "depthwise").depthwise_kernel     # (C,1,3,3)
    taps = kd.float().permute(2, 3, 0, 1).contiguous()           # (3,3,C,1)
    xh = x.permute(0, 2, 3, 1).to(policy.dtype).contiguous()
    out = FDW.fused_dw_bn_relu6(xh, taps, scale.contiguous(),
                                shift.contiguous(), rate=rate)
    return out.permute(0, 3, 1, 2)


def inverted_res_block(net, x, policy, stride: int, block_id: int,
                       skip: bool, rate: int = 1):
    p = _prefix(block_id)
    band = getattr(net, "band", None)
    if _use_fused_dw(net, policy, stride, block_id):
        x = spatial.on_halo(lambda t: fused_dw_apply(net, t, p, rate,
                                                     policy), x, band, rate)
        return getattr(net, p + "project_BN")(
            getattr(net, p + "project")(x, policy))
    if _use_fused_block(net, x, policy, stride, block_id):
        # the kernel's rows a multiple of 8, as the gate asks of the map
        return spatial.on_halo(lambda t: FM.fused_block_apply(
            net, t, p, rate, skip, policy), x, band, rate, 8)
    if FMT.use_fused_train_block(net, x, policy, stride, block_id, p):
        return FMT.fused_train_block_apply(net, x, p, rate, skip, policy)
    inputs = x
    if block_id:
        x = relu6(getattr(net, p + "expand_BN")(
            getattr(net, p + "expand")(x, policy)))
    x = relu6(getattr(net, p + "depthwise_BN")(
        getattr(net, p + "depthwise")(x, policy)))
    x = getattr(net, p + "project_BN")(getattr(net, p + "project")(x, policy))
    return inputs + x if skip else x


def backbone(net, x, policy):
    """Stem + 17 blocks on the normalized NCHW image; output stride 8.  The
    regions ``stem`` and ``mb{block_id:02d}s{stride}`` are the JAX
    package's trace labels (``core.annotate``)."""
    with annotate("stem"):
        x = relu6(net.Conv_BN(net.Conv(x, policy)))
    for _, stride, _, block_id, skip, rate in BLOCK_TABLE:
        with annotate(f"mb{block_id:02d}s{stride}"):
            x = inverted_res_block(net, x, policy, stride, block_id, skip,
                                   rate)
    return x
