"""Conv layers with the reference's exact padding (deeplab_tpu/ops/conv.py).

Tensors are NCHW (usually in channels-last memory, so that a block's
``permute(0, 2, 3, 1)`` is the NHWC layout the fused kernel reads).  Kernels
are stored in PyTorch's layout: OIHW for ``Conv2D.kernel`` and (C, 1, kh, kw)
for ``DepthwiseConv2D.depthwise_kernel``; ``params.py`` converts Keras's HWIO
and (kh, kw, C, 1) on load.

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
from deeplab_tpu_torch.ops import init as inits
from deeplab_tpu_torch.ops.padding import same_pads


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


def depthwise_conv2d(x, kernel, policy: Policy, stride: int = 1,
                     rate: int = 1):
    """Keras DepthwiseConv2D (depth_multiplier 1, no bias, SAME).
    ``kernel``: (C, 1, k, k)."""
    k = kernel.shape[-1]
    pads = (same_pads(x.shape[2], k, stride, rate),
            same_pads(x.shape[3], k, stride, rate))
    return _conv(x, kernel, stride, rate, pads, x.shape[1], policy)


def relu6(x):
    """``min(relu(x), 6)`` with JAX's derivative: 0 at 0 (relu) and 1/2 at
    exactly 6 (``jnp.minimum`` splits a tie; ``torch.minimum`` does too,
    while ``torch.clamp`` would pass 1 at both ends).  In bf16 an activation
    of exactly 6.0 is common.  Without autograd, the one-pass clamp."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, 0.0, 6.0)
    return torch.minimum(torch.relu(x), x.new_tensor(6.0))


class Conv2D(nn.Module):
    frozen = False   # set by the Trainer's freeze policy (read by the gates)

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 rate: int = 1, use_bias: bool = False, gen=None):
        super().__init__()
        self.stride, self.rate = stride, rate
        hwio = inits.glorot_uniform(gen, (kernel_size, kernel_size, cin, cout))
        self.kernel = nn.Parameter(hwio.permute(3, 2, 0, 1).contiguous())
        self.bias = (nn.Parameter(inits.zeros(gen, (cout,))) if use_bias
                     else None)

    def forward(self, x, policy: Policy):
        return conv2d(x, self.kernel, policy, stride=self.stride,
                      rate=self.rate, bias=self.bias)


class DepthwiseConv2D(nn.Module):
    frozen = False

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1,
                 rate: int = 1, gen=None):
        super().__init__()
        self.stride, self.rate = stride, rate
        khwc1 = inits.glorot_uniform(gen, (kernel_size, kernel_size,
                                           channels, 1))
        self.depthwise_kernel = nn.Parameter(
            khwc1.permute(2, 3, 0, 1).contiguous())

    def forward(self, x, policy: Policy):
        return depthwise_conv2d(x, self.depthwise_kernel, policy,
                                stride=self.stride, rate=self.rate)
