"""Work counts against hand-computed values."""

import os

import pytest

from portbench import harness as H
from portbench.work import crf as WC
from portbench.work import deeplabv3p as WD
from portbench.work.peaks import bound_s

MNV2 = H.load_json(os.path.join(H.ROOT, "portbench", "configs",
                                "deeplabv3p_mnv2_os8.json"))
XC = H.load_json(os.path.join(H.ROOT, "portbench", "configs",
                              "deeplabv3p_xception_os16.json"))


def test_mbconv_block():
    """Block 7 at 512x512, B=2: 64 -> 384 -> 64 channels on a 64x64 map,
    rate 2, residual."""
    w = WD.regions(MNV2, 2, 512, 512)["mb07s1"]
    px = 2 * 64 * 64
    assert w.mac == 2 * px * (64 * 384 + 9 * 384 + 384 * 64)
    assert w.other == px * (384 * 3 + 384 * 3 + 64 * 2 + 64)
    weights = 64 * 384 + 9 * 384 + 384 * 64
    assert w.bytes == 2 * weights + 8 * (384 + 384 + 64) + 2 * px * (64 + 64)
    b = WD.backward(w)
    assert b.mac == 2 * w.mac
    assert b.bytes == 2 * (px * 64 + 2 * px * 64) + 2 * 2 * weights


def test_sepconv_bn():
    """One stride-1 SepConv_BN of the middle flow (728 -> 728 on a 32x32
    map at B=1): a leading ReLU, the 3x3 depthwise, BN, the pointwise, BN."""
    r = WD.Work()
    WD._sep(r, 1, 32, 32, 728, 728)
    px = 32 * 32
    assert r.mac == 2 * px * 9 * 728 + 2 * px * 728 * 728
    assert r.other == px * 728 + 2 * px * 728 + 2 * px * 728
    assert r.weights == 9 * 728 + 728 * 728


def test_middle_block_is_three_sepconvs_and_a_sum():
    w = WD.regions(XC, 1, 512, 512)["xmid05"]
    r = WD.Work()
    for _ in range(3):
        WD._sep(r, 1, 32, 32, 728, 728)
    assert w.mac == r.mac
    assert w.other == r.other + 32 * 32 * 728


def test_crf_iteration():
    """One mean-field iteration at PRODUCTION_CONFIG on a 512x512 image,
    21 labels: 64x128 cells (Z = 32, P = 8192), 15 color bins, splat
    stride 2, 17 spatial taps, 5 color taps."""
    c = MNV2["crf"]
    one = WC.flops(dict(c, n_iters=1), 1, 512, 512, 21)
    two = WC.flops(dict(c, n_iters=2), 1, 512, 512, 21)
    Z, P, L, nc = 32, 8192, 21, 15
    D, C, npl = nc * L, nc * nc, Z * L * P
    splat = 2 * 8 * Z * L * (P // 4)
    blur = 2 * (2 * 17 + 1) * npl
    step = 2 * 8 * npl + 2 * 2 * npl + 2 * (25 + 5) * Z * D * C + 20 * npl
    zblur = 2 * Z * Z * D * C
    assert two - one == splat + blur + step + zblur


def test_model_flops_per_image():
    """The MobileNetV2 OS 8 net's conv and resize FLOPs at 512x512 and
    the training step's three passes (the stem has no data gradient, the
    resize no weight gradient)."""
    fwd = WD.model_flops(MNV2, 512, 512)
    assert 17.5e9 < fwd < 18.5e9
    regions = WD.regions(MNV2, 1, 512, 512)
    stem, head = regions["stem"], regions["head"]
    expect = 3 * fwd - stem.mac - head.resize
    assert WD.train_flops(MNV2, 512, 512) == pytest.approx(expect)


def test_bound_takes_the_larger_time():
    assert bound_s(989e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert bound_s(989e9, 3.35e12) == pytest.approx(1.0)
