"""Aligned Xception backbone for DeepLabV3+ (deeplab_tpu/models/xception.py).

Stem (two 3x3 convs), the entry flow's three blocks (strides 2, 2 and 2 at
output stride 16 or 1 at 8), 16 middle-flow units and the exit flow with
atrous rates; every block is three SepConv_BN layers with a ``conv``,
``sum`` or ``none`` skip.  Layer names match the Keras graph (the weight
contract); every BN of the trunk has eps 1e-3 and momentum 0.99.  The
eval-mode stride-1 SepConvs take the fused kernel (ops/conv.py's gate).
"""

from __future__ import annotations

from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.ops.conv import (Conv2D, build_sep_conv_bn, relu,
                                        sep_conv_bn)


def rate_table(OS: int):
    """(entry_block3_stride, middle_block_rate, exit_block_rates,
    atrous_rates) for output stride 8 or 16."""
    if OS == 8:
        return 1, 2, (2, 4), (12, 24, 36)
    if OS == 16:
        return 2, 1, (1, 2), (6, 12, 18)
    raise ValueError(f"Xception runs at output stride 8 or 16, not {OS}")


def block_table(OS: int):
    """(prefix, depth_list, skip type, stride, rate, depth_activation) of
    every Xception block, in graph order."""
    s3, mid_rate, exit_rates, _ = rate_table(OS)
    return ((("entry_flow_block1", (128, 128, 128), "conv", 2, 1, False),
             ("entry_flow_block2", (256, 256, 256), "conv", 2, 1, False),
             ("entry_flow_block3", (728, 728, 728), "conv", s3, 1, False))
            + tuple((f"middle_flow_unit_{i + 1}", (728, 728, 728), "sum", 1,
                     mid_rate, False) for i in range(16))
            + (("exit_flow_block1", (728, 1024, 1024), "conv", 1,
                exit_rates[0], False),
               ("exit_flow_block2", (1536, 1536, 2048), "none", 1,
                exit_rates[1], True)))


def build_backbone(add, gen, OS: int = 16) -> int:
    """Register the trunk's layers through ``add(name, module)``; returns
    the output channel count (2048).  The decoder skip has 256 channels."""
    add("entry_flow_conv1_1", Conv2D(3, 32, 3, stride=2, gen=gen))
    add("entry_flow_conv1_1_BN", BatchNorm(32, 1e-3, gen))
    add("entry_flow_conv1_2", Conv2D(32, 64, 3, gen=gen, padding="fixed"))
    add("entry_flow_conv1_2_BN", BatchNorm(64, 1e-3, gen))
    c = 64
    for prefix, depths, skip, stride, rate, _ in block_table(OS):
        cin = c
        for i in range(3):
            c = build_sep_conv_bn(add, gen, f"{prefix}_separable_conv{i + 1}",
                                  c, depths[i], stride if i == 2 else 1, rate)
        if skip == "conv":
            add(prefix + "_shortcut", Conv2D(cin, depths[-1], 1, stride=stride,
                                             gen=gen, padding="fixed"))
            add(prefix + "_shortcut_BN", BatchNorm(depths[-1], 1e-3, gen))
    return c


def xception_block(net, x, policy, prefix: str, skip: str,
                   depth_activation: bool = False, return_skip: bool = False):
    """Reference _xception_block (JAX ``xception_block``): three
    SepConv_BNs and the ``conv``, ``sum`` or ``none`` shortcut; with
    ``return_skip`` also the second SepConv's output.  The ``sum`` skip adds
    the block's input as it came in, before any SepConv's ReLU."""
    inputs = residual = x
    for i in range(3):
        residual = sep_conv_bn(net, residual, policy,
                               f"{prefix}_separable_conv{i + 1}",
                               depth_activation)
        if i == 1:
            second = residual
    if skip == "conv":
        residual = residual + getattr(net, prefix + "_shortcut_BN")(
            getattr(net, prefix + "_shortcut")(inputs, policy))
    elif skip == "sum":
        residual = residual + inputs
    return (residual, second) if return_skip else residual


def backbone(net, x, policy, OS: int = 16):
    """Stem and blocks on the normalized NCHW image; returns ``(features,
    skip1)``: the trunk's output at stride ``OS`` and entry block 2's second
    SepConv output at stride 4."""
    x = relu(net.entry_flow_conv1_1_BN(net.entry_flow_conv1_1(x, policy)))
    x = relu(net.entry_flow_conv1_2_BN(net.entry_flow_conv1_2(x, policy)))
    skip1 = None
    for prefix, _, skip, _, _, depth_act in block_table(OS):
        if prefix == "entry_flow_block2":
            x, skip1 = xception_block(net, x, policy, prefix, skip, depth_act,
                                      return_skip=True)
        else:
            x = xception_block(net, x, policy, prefix, skip, depth_act)
    return x, skip1
