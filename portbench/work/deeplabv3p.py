"""Operations and bytes of DeepLabV3+ by trace region, from the
configuration's shapes.

A region is the program's trace label (``stem``, ``mbNNsS``, ``aspp``,
``xstem``, ``xentry1``-``3``, ``xmidNN``, ``xexit1``-``2``) or, for what
has no label, ``head`` (the 1x1 head conv, the resize to the input and the
argmax) and ``decoder`` (Xception's).  Each :class:`Work` holds

- ``mac``: 2 x the multiply-adds of the convs and resize products;
- ``other``: the elementwise operations (BN affine 2, activation 1,
  residual add 1 a value, the input normalization 2);
- ``bytes``: the region's input activations read once and output written
  once, at 2 bytes a value (bf16, the operand precision of both policies
  the benchmark runs, so the least any implementation must move), and its
  weights once at 2 bytes, BN affines at 8 bytes a channel.

``backward`` gives a region's data- and weight-gradient work: 2 x its
forward products, its elementwise work again, and dy and x read, dx
written, dW written.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from portbench.reference import model as R

ACT = 2      # bytes a value
WGT = 2      # bytes a weight
AFF = 8      # bytes a BN channel (scale and shift, f32)


@dataclass
class Work:
    mac: float = 0.0
    other: float = 0.0
    bytes: float = 0.0
    # for the backward: input and output values, weights
    x_vals: float = 0.0
    y_vals: float = 0.0
    weights: float = 0.0
    resize: float = 0.0       # products without weights (in ``mac``)
    first: bool = False       # takes the image: no data gradient

    @property
    def flops(self):
        return self.mac + self.other

    def add(self, o: "Work"):
        self.mac += o.mac
        self.other += o.other
        self.bytes += o.bytes
        self.weights += o.weights


def _conv(B, h, w, cin, cout, k=1, stride=1, depthwise=False):
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    taps = k * k * (1 if depthwise else cin)
    mac = 2.0 * B * ho * wo * taps * cout
    wts = taps * cout
    return Work(mac=mac, weights=wts, bytes=WGT * wts), ho, wo


def _bn_act(B, h, w, c, act=True):
    return Work(other=B * h * w * c * (3 if act else 2), bytes=AFF * c)


class _Builder:
    """Accumulates the work of the region being walked."""

    def __init__(self, B):
        self.B = B
        self.regions = {}

    def region(self, name, B, h, w, cin):
        work = Work(x_vals=B * h * w * cin)
        self.regions[name] = work
        return work

    def close(self, work, h, w, c):
        work.y_vals = self.B * h * w * c
        work.bytes += ACT * (work.x_vals + work.y_vals)


def regions(cfg: dict, B: int, H: int, W: int) -> dict:
    """{region: Work} of one forward of ``B`` images of H x W."""
    b = _Builder(B)
    if cfg["backbone"] == "mobilenetv2":
        c, h, w = _mobilenet(b, cfg, B, H, W)
        OS, dec = 8, None
    else:
        c, h, w, dec = _xception(b, cfg, B, H, W)
        OS = cfg["output_stride"]
    # ASPP
    r = b.region("aspp", B, h, w, c)
    r.other += B * h * w * c                               # the image pool
    for cin, cout, hh, ww in ((c, 256, 1, 1), (c, 256, h, w)):
        cw, _, _ = _conv(B, hh, ww, cin, cout)
        r.add(cw)
        r.add(_bn_act(B, hh, ww, cout))
    branches = 2
    if cfg["backbone"] == "xception":
        for _ in R.xception_rates(OS)[3]:
            _sep(r, B, h, w, c, 256)
        branches = 5
    cw, _, _ = _conv(B, h, w, 256 * branches, 256)
    r.add(cw)
    r.add(_bn_act(B, h, w, 256))
    b.close(r, h, w, 256)
    c = 256
    if dec is not None:
        h4, w4, skip_c = dec
        r = b.region("decoder", B, h, w, c)
        r.x_vals += B * h4 * w4 * skip_c
        rs = 2.0 * B * c * (h4 * h * w + h4 * w * w4)     # resize to s4
        r.mac += rs
        r.resize += rs
        cw, _, _ = _conv(B, h4, w4, skip_c, 48)
        r.add(cw)
        r.add(_bn_act(B, h4, w4, 48))
        _sep(r, B, h4, w4, 304, 256)
        _sep(r, B, h4, w4, 256, 256)
        b.close(r, h4, w4, 256)
        h, w = h4, w4
    n = cfg["n_classes"]
    r = b.region("head", B, h, w, c)
    cw, _, _ = _conv(B, h, w, c, n)
    r.add(cw)
    r.other += B * h * w * n                               # the bias
    rs = 2.0 * B * n * (H * h * w + H * w * W)             # resize
    r.mac += rs
    r.resize += rs
    r.other += B * H * W * n                               # argmax
    r.y_vals = B * H * W * n
    r.bytes += ACT * r.x_vals + B * H * W                  # labels, 1 byte
    return b.regions


def _mobilenet(b, cfg, B, H, W):
    alpha = cfg.get("alpha", 1.0)
    c = R.make_divisible(32 * alpha)
    r = b.region("stem", B, H, W, 3)
    r.first = True
    r.other += 2.0 * B * H * W * 3                         # x / 127.5 - 1
    cw, h, w = _conv(B, H, W, 3, c, 3, 2)
    r.add(cw)
    r.add(_bn_act(B, h, w, c))
    b.close(r, h, w, c)
    for filters, stride, expansion, bid, skip, _ in R.MBV2_BLOCKS:
        r = b.region(f"mb{bid:02d}s{stride}", B, h, w, c)
        ce = c
        if bid:
            ce = expansion * c
            cw, _, _ = _conv(B, h, w, c, ce)
            r.add(cw)
            r.add(_bn_act(B, h, w, ce))
        cw, ho, wo = _conv(B, h, w, ce, ce, 3, stride, depthwise=True)
        r.add(cw)
        r.add(_bn_act(B, ho, wo, ce))
        cout = R.make_divisible(int(filters * alpha))
        cw, _, _ = _conv(B, ho, wo, ce, cout)
        r.add(cw)
        r.add(_bn_act(B, ho, wo, cout, act=False))
        if skip:
            r.other += B * ho * wo * cout
        b.close(r, ho, wo, cout)
        c, h, w = cout, ho, wo
    return c, h, w


def _sep(r, B, h, w, cin, cout, stride=1):
    """A SepConv_BN's work into ``r``; returns the output size."""
    r.other += B * h * w * cin                             # the leading ReLU
    cw, ho, wo = _conv(B, h, w, cin, cin, 3, stride, depthwise=True)
    r.add(cw)
    r.add(_bn_act(B, ho, wo, cin, act=False))
    cw, _, _ = _conv(B, ho, wo, cin, cout)
    r.add(cw)
    r.add(_bn_act(B, ho, wo, cout, act=False))
    return ho, wo


_LABEL = {"entry_flow_block1": "xentry1", "entry_flow_block2": "xentry2",
          "entry_flow_block3": "xentry3", "exit_flow_block1": "xexit1",
          "exit_flow_block2": "xexit2"}


def _xlabel(prefix):
    if prefix.startswith("middle_flow_unit_"):
        return f"xmid{int(prefix.rsplit('_', 1)[1]):02d}"
    return _LABEL[prefix]


def _xception(b, cfg, B, H, W):
    r = b.region("xstem", B, H, W, 3)
    r.first = True
    r.other += 2.0 * B * H * W * 3
    cw, h, w = _conv(B, H, W, 3, 32, 3, 2)
    r.add(cw)
    r.add(_bn_act(B, h, w, 32))
    cw, _, _ = _conv(B, h, w, 32, 64, 3)
    r.add(cw)
    r.add(_bn_act(B, h, w, 64))
    b.close(r, h, w, 64)
    c, dec = 64, None
    for prefix, depths, skip, stride, _, _ in R.xception_blocks(
            cfg["output_stride"]):
        r = b.region(_xlabel(prefix), B, h, w, c)
        hh, ww, cc = h, w, c
        for i in range(3):
            hh, ww = _sep(r, B, hh, ww, cc, depths[i],
                          stride if i == 2 else 1)
            cc = depths[i]
            if i == 1 and prefix == "entry_flow_block2":
                dec = (hh, ww, cc)
        if skip == "conv":
            cw, _, _ = _conv(B, h, w, c, depths[-1], 1, stride)
            r.add(cw)
            r.add(_bn_act(B, hh, ww, depths[-1], act=False))
        if skip != "none":
            r.other += B * hh * ww * depths[-1]
        b.close(r, hh, ww, depths[-1])
        c, h, w = depths[-1], hh, ww
    return c, h, w, dec


def backward(work: Work) -> Work:
    """The data- and weight-gradient work of a forward region (a resize
    has a data gradient only; the first region no data gradient)."""
    convs = work.mac - work.resize
    mac = convs * (1.0 if work.first else 2.0) + work.resize
    vals = work.y_vals + work.x_vals * (1 if work.first else 2)
    return Work(mac=mac, other=work.other,
                bytes=ACT * vals + 2 * WGT * work.weights)


def model_flops(cfg, H, W) -> float:
    """Conv and resize FLOPs of one image's forward."""
    return sum(r.mac for r in regions(cfg, 1, H, W).values())


def train_flops(cfg, H, W) -> float:
    """Forward, data-gradient and weight-gradient FLOPs of one training
    image (the argmax is no part of a step; the loss's few operations a
    value are left out)."""
    total = 0.0
    for r in regions(cfg, 1, H, W).values():
        total += r.mac + backward(r).mac
    return total
