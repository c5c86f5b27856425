"""Plain DeepLabV3+ in PyTorch, float32, for the benchmark's comparisons.

The graph of arXiv:1802.02611 as the reference Keras code
(``Golbstein/Keras-segmentation-deeplab-v3.1``, ``deeplabv3p.py``) builds
it, truncated where its ``SegModel`` truncates it, with the 'original'
head (a 1x1 conv with bias, then a TF1 bilinear resize to the input):

- MobileNetV2 (arXiv:1801.04381) at output stride 8: the stem and 17
  inverted-residual blocks, blocks 7-12 at rate 2 and 14-16 at rate 4; BN
  eps 1e-3.  ASPP: the image pool and the 1x1 branch.
- Aligned Xception at output stride 16 or 8: a two-conv stem, 3 entry,
  16 middle and 2 exit blocks of three SepConv_BNs; BN eps 1e-3.  ASPP
  adds three atrous SepConvs, and the decoder fuses the stride-4 skip.

Keras padding: SAME (split low-first) and the reference's fixed pads for
strided SepConvs and shortcuts.  Images are BGR 0-255, normalized in the
graph as ``x / 127.5 - 1``.

Everything is a function of a dict of named weight tensors (the Keras
layer names, ``<layer>.kernel`` OIHW, ``<layer>.depthwise_kernel``
(C, 1, 3, 3), ``<bn>.gamma`` ...).  ``layer_specs`` lists them with their
shapes.  ``quant`` rounds every conv operand (a lower precision for a
control run; where it has ``grad_out``, that rounds each conv's output
gradient in a backward); ``None`` keeps float32.  The caller turns TF32 off.

This module imports torch only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# (filters, stride, expansion, block_id, skip, rate)
MBV2_BLOCKS = (
    (16, 1, 1, 0, False, 1), (24, 2, 6, 1, False, 1), (24, 1, 6, 2, True, 1),
    (32, 2, 6, 3, False, 1), (32, 1, 6, 4, True, 1), (32, 1, 6, 5, True, 1),
    (64, 1, 6, 6, False, 1), (64, 1, 6, 7, True, 2), (64, 1, 6, 8, True, 2),
    (64, 1, 6, 9, True, 2), (96, 1, 6, 10, False, 2),
    (96, 1, 6, 11, True, 2), (96, 1, 6, 12, True, 2),
    (160, 1, 6, 13, False, 2), (160, 1, 6, 14, True, 4),
    (160, 1, 6, 15, True, 4), (320, 1, 6, 16, False, 4),
)


def make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def mb_prefix(block_id: int) -> str:
    return f"expanded_conv_{block_id}_" if block_id else "expanded_conv_"


def xception_rates(OS: int):
    """(entry block 3 stride, middle rate, exit rates, ASPP rates)."""
    if OS == 8:
        return 1, 2, (2, 4), (12, 24, 36)
    if OS == 16:
        return 2, 1, (1, 2), (6, 12, 18)
    raise ValueError(f"Xception runs at output stride 8 or 16, not {OS}")


def xception_blocks(OS: int):
    """(prefix, depths, skip, stride, rate, depth_activation) in order."""
    s3, mid, exit_rates, _ = xception_rates(OS)
    return ((("entry_flow_block1", (128, 128, 128), "conv", 2, 1, False),
             ("entry_flow_block2", (256, 256, 256), "conv", 2, 1, False),
             ("entry_flow_block3", (728, 728, 728), "conv", s3, 1, False))
            + tuple((f"middle_flow_unit_{i + 1}", (728, 728, 728), "sum", 1,
                     mid, False) for i in range(16))
            + (("exit_flow_block1", (728, 1024, 1024), "conv", 1,
                exit_rates[0], False),
               ("exit_flow_block2", (1536, 1536, 2048), "none", 1,
                exit_rates[1], True)))


# ---------------------------------------------------------------- specs ----

def layer_specs(cfg: dict):
    """[(name, shape, kind)] of every weight, in graph order.  ``kind``:
    ``conv`` (OIHW), ``dw`` (C, 1, k, k), ``bias``, ``gamma``, ``beta``,
    ``mean``, ``var``."""
    out = []

    def conv(name, cin, cout, k=1, bias=False):
        out.append((name + ".kernel", (cout, cin, k, k), "conv"))
        if bias:
            out.append((name + ".bias", (cout,), "bias"))

    def dw(name, c, k=3):
        out.append((name + ".depthwise_kernel", (c, 1, k, k), "dw"))

    def bn(name, c):
        for field, kind in (("gamma", "gamma"), ("beta", "beta"),
                            ("moving_mean", "mean"),
                            ("moving_variance", "var")):
            out.append((f"{name}.{field}", (c,), kind))

    def sep(prefix, cin, cout):
        dw(prefix + "_depthwise", cin)
        bn(prefix + "_depthwise_BN", cin)
        conv(prefix + "_pointwise", cin, cout)
        bn(prefix + "_pointwise_BN", cout)

    if cfg["backbone"] == "mobilenetv2":
        c = make_divisible(32 * cfg.get("alpha", 1.0))
        conv("Conv", 3, c, 3)
        bn("Conv_BN", c)
        for filters, _, expansion, bid, _, _ in MBV2_BLOCKS:
            p = mb_prefix(bid)
            ce = c
            if bid:
                ce = expansion * c
                conv(p + "expand", c, ce)
                bn(p + "expand_BN", ce)
            dw(p + "depthwise", ce)
            bn(p + "depthwise_BN", ce)
            c = make_divisible(int(filters * cfg.get("alpha", 1.0)))
            conv(p + "project", ce, c)
            bn(p + "project_BN", c)
    else:
        conv("entry_flow_conv1_1", 3, 32, 3)
        bn("entry_flow_conv1_1_BN", 32)
        conv("entry_flow_conv1_2", 32, 64, 3)
        bn("entry_flow_conv1_2_BN", 64)
        c = 64
        for prefix, depths, skip, _, _, _ in xception_blocks(
                cfg["output_stride"]):
            cin = c
            for i in range(3):
                sep(f"{prefix}_separable_conv{i + 1}", c, depths[i])
                c = depths[i]
            if skip == "conv":
                conv(prefix + "_shortcut", cin, depths[-1])
                bn(prefix + "_shortcut_BN", depths[-1])
    conv("image_pooling", c, 256)
    bn("image_pooling_BN", 256)
    conv("aspp0", c, 256)
    bn("aspp0_BN", 256)
    branches = 2
    if cfg["backbone"] == "xception":
        for i in (1, 2, 3):
            sep(f"aspp{i}", c, 256)
        branches = 5
    conv("concat_projection", 256 * branches, 256)
    bn("concat_projection_BN", 256)
    if cfg["backbone"] == "xception":
        conv("feature_projection0", 256, 48)
        bn("feature_projection0_BN", 48)
        sep("decoder_conv0", 304, 256)
        sep("decoder_conv1", 256, 256)
    conv("conv_upsample", 256, cfg["n_classes"], 1, bias=True)
    return out


# ------------------------------------------------------------ the graph ----

def same_pads(n: int, k: int, stride: int, rate: int):
    eff = k + (k - 1) * (rate - 1)
    total = max((math.ceil(n / stride) - 1) * stride + eff - n, 0)
    return total // 2, total - total // 2


def fixed_pads(k: int, rate: int):
    total = k + (k - 1) * (rate - 1) - 1
    return total // 2, total - total // 2


def bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(out, in) TF1 ``resize_bilinear`` (align_corners=False) weights."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for d in range(n_out):
        src = d * scale
        lo = min(int(np.floor(src)), n_in - 1)
        hi = min(lo + 1, n_in - 1)
        m[d, lo] += 1.0 - (src - lo)
        m[d, hi] += src - lo
    return m


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """TF1 bilinear resize of NCHW float32 ``x`` to ``size``."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    mh = torch.from_numpy(bilinear_matrix(h, size[0])).to(x.device)
    mw = torch.from_numpy(bilinear_matrix(w, size[1])).to(x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())


class Graph:
    """One forward over weights ``w``.  ``bn``: ``"eval"`` (moving
    statistics), ``"train"`` (batch statistics, biased variance) or
    ``"calibrate"`` (batch statistics, each BN's recorded in
    ``self.stats``).  ``dropout``: a callable ``x -> x`` applied after
    ASPP (training), or None."""

    def __init__(self, cfg, w, bn="eval", quant=None, dropout=None):
        self.cfg, self.w, self.mode = cfg, w, bn
        self.quant, self.dropout = quant, dropout
        self.stats = {}

    def conv(self, x, name, stride=1, rate=1, pads="same", groups=1,
             kind="kernel"):
        k = self.w[f"{name}.{kind}"]
        kk = k.shape[-1]
        if pads == "same":
            ph = same_pads(x.shape[2], kk, stride, rate)
            pw = same_pads(x.shape[3], kk, stride, rate)
        elif pads == "fixed":
            ph = pw = fixed_pads(kk, rate)
        else:
            ph = pw = (0, 0)
        if any(ph) or any(pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        if self.quant is not None:
            x, k = self.quant(x), self.quant(k)
        y = F.conv2d(x, k, stride=stride, dilation=rate, groups=groups)
        if hasattr(self.quant, "grad_out"):
            y = self.quant.grad_out(y)
        bias = self.w.get(f"{name}.bias")
        return y if bias is None else y + bias[:, None, None]

    def dwconv(self, x, name, stride=1, rate=1, pads="same"):
        return self.conv(x, name, stride, rate, pads, groups=x.shape[1],
                         kind="depthwise_kernel")

    def bn(self, x, name, eps):
        w = self.w
        if self.mode == "eval":
            mean, var = w[name + ".moving_mean"], w[name + ".moving_variance"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if self.mode == "calibrate":
                self.stats[name] = (mean.detach(), var.detach())
        scale = w[name + ".gamma"] * torch.rsqrt(var + eps)
        shift = w[name + ".beta"] - mean * scale
        return x * scale[:, None, None] + shift[:, None, None]

    def sep_conv_bn(self, x, prefix, stride=1, rate=1, depth_activation=False,
                    eps=1e-3):
        if not depth_activation:
            x = torch.relu(x)
        x = self.bn(self.dwconv(x, prefix + "_depthwise", stride, rate,
                                "same" if stride == 1 else "fixed"),
                    prefix + "_depthwise_BN", eps)
        if depth_activation:
            x = torch.relu(x)
        x = self.bn(self.conv(x, prefix + "_pointwise"),
                    prefix + "_pointwise_BN", eps)
        return torch.relu(x) if depth_activation else x

    def mobilenetv2(self, x):
        relu6 = lambda t: torch.clamp(t, 0.0, 6.0)
        x = relu6(self.bn(self.conv(x, "Conv", stride=2), "Conv_BN", 1e-3))
        for _, stride, _, bid, skip, rate in MBV2_BLOCKS:
            p = mb_prefix(bid)
            inputs = x
            if bid:
                x = relu6(self.bn(self.conv(x, p + "expand"), p + "expand_BN",
                                  1e-3))
            x = relu6(self.bn(self.dwconv(x, p + "depthwise", stride, rate),
                              p + "depthwise_BN", 1e-3))
            x = self.bn(self.conv(x, p + "project"), p + "project_BN", 1e-3)
            x = inputs + x if skip else x
        return x, None

    def xception(self, x):
        x = torch.relu(self.bn(self.conv(x, "entry_flow_conv1_1", stride=2),
                               "entry_flow_conv1_1_BN", 1e-3))
        x = torch.relu(self.bn(self.conv(x, "entry_flow_conv1_2"),
                               "entry_flow_conv1_2_BN", 1e-3))
        skip1 = None
        for prefix, _, skip, stride, rate, act in xception_blocks(
                self.cfg["output_stride"]):
            inputs = res = x
            for i in range(3):
                res = self.sep_conv_bn(res, f"{prefix}_separable_conv{i + 1}",
                                       stride if i == 2 else 1, rate, act)
                if i == 1 and prefix == "entry_flow_block2":
                    skip1 = res
            if skip == "conv":
                res = res + self.bn(self.conv(inputs, prefix + "_shortcut",
                                              stride=stride, pads="fixed"),
                                    prefix + "_shortcut_BN", 1e-3)
            elif skip == "sum":
                res = res + inputs
            x = res
        return x, skip1

    def features(self, img):
        """(B, H, W, 3) BGR 0-255 float32 -> NCHW head input."""
        cfg = self.cfg
        H, W = img.shape[1:3]
        x = (img / 127.5 - 1.0).permute(0, 3, 1, 2)
        xception = cfg["backbone"] == "xception"
        OS = cfg["output_stride"] if xception else 8
        x, skip1 = self.xception(x) if xception else self.mobilenetv2(x)
        fh, fw = math.ceil(H / OS), math.ceil(W / OS)
        b4 = x.mean(dim=(2, 3), keepdim=True)
        b4 = torch.relu(self.bn(self.conv(b4, "image_pooling"),
                                "image_pooling_BN", 1e-5))
        if self.mode == "calibrate":
            # the pooled features of a few photos barely differ, and their
            # batch variance would scale any rounding of the pool up many
            # times: the pool BN takes the variance of its conv over pixels
            mean = self.stats["image_pooling_BN"][0]
            pix = self.conv(x, "image_pooling").var(dim=(0, 2, 3),
                                                    unbiased=False)
            self.stats["image_pooling_BN"] = (mean, pix)
        branches = [b4.expand(-1, -1, fh, fw),
                    torch.relu(self.bn(self.conv(x, "aspp0"), "aspp0_BN",
                                       1e-5))]
        if xception:
            for i, rate in enumerate(xception_rates(OS)[3]):
                branches.append(self.sep_conv_bn(x, f"aspp{i + 1}", 1, rate,
                                                 True, 1e-5))
        x = torch.relu(self.bn(self.conv(torch.cat(branches, 1),
                                         "concat_projection"),
                               "concat_projection_BN", 1e-5))
        if self.dropout is not None:
            x = self.dropout(x)
        if xception:
            x = resize_bilinear(x, (math.ceil(H / 4), math.ceil(W / 4)))
            s = torch.relu(self.bn(self.conv(skip1, "feature_projection0"),
                                   "feature_projection0_BN", 1e-5))
            x = torch.cat([x, s], 1)
            x = self.sep_conv_bn(x, "decoder_conv0", 1, 1, True, 1e-5)
            x = self.sep_conv_bn(x, "decoder_conv1", 1, 1, True, 1e-5)
        return x

    def logits(self, img):
        """(B, H, W, 3) -> (B, n_classes, H, W) float32 logits."""
        x = self.conv(self.features(img), "conv_upsample")
        return resize_bilinear(x, tuple(img.shape[1:3]))


def logits(cfg, w, img, quant=None):
    """Eval-mode logits (B, n, H, W) of ``img`` (B, H, W, 3)."""
    with torch.no_grad():
        return Graph(cfg, w, "eval", quant).logits(img)


def calibrate(cfg, w, img):
    """Each BN's batch (mean, biased variance) over ``img``, every BN
    normalizing with its own batch's statistics (one calibration batch)."""
    g = Graph(cfg, w, "calibrate")
    with torch.no_grad():
        g.logits(img)
    return g.stats
