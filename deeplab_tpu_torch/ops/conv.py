"""Conv layers with the reference's exact padding (deeplab_tpu/ops/conv.py).

Tensors are NCHW (usually in channels-last memory, so that a block's
``permute(0, 2, 3, 1)`` is the NHWC layout the fused kernel reads).  Kernels
are stored in PyTorch's layout: OIHW for ``Conv2D.kernel`` and (C, 1, kh, kw)
for ``DepthwiseConv2D.depthwise_kernel``; ``params.py`` converts Keras's HWIO
and (kh, kw, C, 1) on load.

``sep_conv_bn`` is the reference SepConv_BN: its four layers are
submodules of the network named ``<prefix>_depthwise``, ``_depthwise_BN``,
``_pointwise`` and ``_pointwise_BN`` (the weight contract).  Eval-mode
stride-1 SepConvs under the bf16 and "mixed" policies run through the fused
kernel ``kernels/fused_mbconv.py::fused_sepconv`` instead.

Precision (core.Policy): float32 convs run in f32; under "mixed" both
operands are rounded to bf16 and the conv runs in f32 (f32 accumulation and
output, like JAX's DEFAULT-precision f32 conv); under bfloat16 the conv takes
and returns bf16, also under autograd (its gradient reaches the f32 kernel
through the cast).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deeplab_tpu_torch.core import Policy
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.ops import init as inits
from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.ops.padding import manual_pads, same_pads


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _conv(x, kernel, stride: int, rate: int, pads_hw, groups: int,
          policy: Policy):
    (ph0, ph1), (pw0, pw1) = pads_hw
    if ph0 or ph1 or pw0 or pw1:
        x = F.pad(x, (pw0, pw1, ph0, ph1))
    if x.dtype == torch.float32:
        w = kernel.float()
        if policy.mxu_bf16:
            x, w = _round_bf16(x), _round_bf16(w)
    else:
        w = kernel.to(x.dtype)
    return F.conv2d(x, w, stride=stride, dilation=rate, groups=groups)


def conv2d(x, kernel, policy: Policy, stride: int = 1, rate: int = 1,
           bias=None, padding: str = "same"):
    """Keras Conv2D.  ``kernel``: (out, in, k, k)."""
    k = kernel.shape[-1]
    if padding == "same":
        pads = (same_pads(x.shape[2], k, stride, rate),
                same_pads(x.shape[3], k, stride, rate))
    else:
        pads = ((0, 0), (0, 0))
    y = _conv(x, kernel, stride, rate, pads, 1, policy)
    if bias is not None:
        y = y + bias.to(y.dtype)[:, None, None]
    return y


def conv2d_fixed(x, kernel, policy: Policy, stride: int = 1, rate: int = 1):
    """Reference ``_conv2d_same`` (JAX ``conv2d_fixed``): SAME at stride 1;
    at a larger stride the input-size independent ``manual_pads`` and a
    VALID conv."""
    if stride == 1:
        return conv2d(x, kernel, policy, rate=rate)
    p = manual_pads(kernel.shape[-1], rate)
    return _conv(x, kernel, stride, rate, (p, p), 1, policy)


def depthwise_conv2d(x, kernel, policy: Policy, stride: int = 1,
                     rate: int = 1, explicit_pads=None):
    """Keras DepthwiseConv2D (depth_multiplier 1, no bias): SAME, or
    ``explicit_pads`` (lo, hi) on both axes and VALID.  ``kernel``: (C, 1,
    k, k)."""
    k = kernel.shape[-1]
    if explicit_pads is not None:
        pads = (tuple(explicit_pads), tuple(explicit_pads))
    else:
        pads = (same_pads(x.shape[2], k, stride, rate),
                same_pads(x.shape[3], k, stride, rate))
    return _conv(x, kernel, stride, rate, pads, x.shape[1], policy)


def relu(x):
    return torch.relu(x)


def relu6(x):
    """``min(relu(x), 6)`` with JAX's derivative: 0 at 0 (relu) and 1/2 at
    exactly 6 (``jnp.minimum`` splits a tie; ``torch.minimum`` does too,
    while ``torch.clamp`` would pass 1 at both ends).  In bf16 an activation
    of exactly 6.0 is common.  Without autograd, the one-pass clamp."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, 0.0, 6.0)
    return torch.minimum(torch.relu(x), x.new_tensor(6.0))


class Conv2D(nn.Module):
    """Keras Conv2D; ``padding="fixed"`` is :func:`conv2d_fixed` (no
    bias).  ``kernel_init(gen, hwio_shape)`` draws the kernel in the Keras
    layout."""
    frozen = False   # set by the Trainer's freeze policy (read by the gates)

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 rate: int = 1, use_bias: bool = False, gen=None,
                 padding: str = "same", kernel_init=inits.glorot_uniform):
        super().__init__()
        self.stride, self.rate, self.padding = stride, rate, padding
        hwio = kernel_init(gen, (kernel_size, kernel_size, cin, cout))
        self.kernel = nn.Parameter(hwio.permute(3, 2, 0, 1).contiguous())
        self.bias = (nn.Parameter(inits.zeros(gen, (cout,))) if use_bias
                     else None)

    def forward(self, x, policy: Policy):
        if self.padding == "fixed":
            return conv2d_fixed(x, self.kernel, policy, self.stride,
                                self.rate)
        return conv2d(x, self.kernel, policy, stride=self.stride,
                      rate=self.rate, bias=self.bias)


class DepthwiseConv2D(nn.Module):
    """Keras DepthwiseConv2D; ``padding="fixed"`` pads ``manual_pads`` and
    runs VALID (the strided SepConv_BN)."""
    frozen = False

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1,
                 rate: int = 1, gen=None, padding: str = "same"):
        super().__init__()
        self.stride, self.rate, self.padding = stride, rate, padding
        khwc1 = inits.glorot_uniform(gen, (kernel_size, kernel_size,
                                           channels, 1))
        self.depthwise_kernel = nn.Parameter(
            khwc1.permute(2, 3, 0, 1).contiguous())

    def forward(self, x, policy: Policy):
        k = self.depthwise_kernel.shape[-1]
        pads = manual_pads(k, self.rate) if self.padding == "fixed" else None
        return depthwise_conv2d(x, self.depthwise_kernel, policy,
                                stride=self.stride, rate=self.rate,
                                explicit_pads=pads)


def build_sep_conv_bn(add, gen, prefix: str, cin: int, filters: int,
                      stride: int = 1, rate: int = 1,
                      epsilon: float = 1e-3) -> int:
    """Register one SepConv_BN's layers through ``add(name, module)``: the
    3x3 depthwise (dilation ``rate``; SAME at stride 1, the fixed pads and
    VALID at a larger stride), its BN, the 1x1 pointwise and its BN, both
    BNs with ``epsilon``.  Returns ``filters``."""
    add(prefix + "_depthwise", DepthwiseConv2D(
        cin, 3, stride, rate, gen=gen,
        padding="same" if stride == 1 else "fixed"))
    add(prefix + "_depthwise_BN", BatchNorm(cin, epsilon, gen))
    add(prefix + "_pointwise", Conv2D(cin, filters, 1, gen=gen))
    add(prefix + "_pointwise_BN", BatchNorm(filters, epsilon, gen))
    return filters


def use_fused_sepconv(net, policy: Policy, stride: int) -> bool:
    """The fused kernel serves eval-mode stride-1 SepConv_BN layers under
    the bf16 and "mixed" policies (the gate of the MobileNetV2 blocks; the
    kernel takes any map size and rate).  On a CUDA tensor the layer then
    runs the kernel; on a CPU tensor its plain version.  The float32 policy,
    training and ``fuse_blocks=False`` keep the composition."""
    return bool(net.fuse_blocks and stride == 1 and not net.training
                and (policy.dtype == torch.bfloat16
                     or (policy.dtype == torch.float32 and policy.mxu_bf16)))


def sep_conv_bn(net, x, policy: Policy, prefix: str,
                depth_activation: bool = False):
    """Reference SepConv_BN (JAX ``ops/conv.py::sep_conv_bn``) over the
    layers ``build_sep_conv_bn`` registered on ``net``:
    [not depth_activation: ReLU first] -> depthwise -> BN -> [ReLU] ->
    pointwise -> BN -> [ReLU]."""
    dw = getattr(net, prefix + "_depthwise")
    if use_fused_sepconv(net, policy, dw.stride):
        return FM.fused_sepconv_apply(net, x, prefix, dw.rate,
                                      depth_activation, policy)
    if not depth_activation:
        x = relu(x)
    x = getattr(net, prefix + "_depthwise_BN")(dw(x, policy))
    if depth_activation:
        x = relu(x)
    x = getattr(net, prefix + "_pointwise_BN")(
        getattr(net, prefix + "_pointwise")(x, policy))
    if depth_activation:
        x = relu(x)
    return x
