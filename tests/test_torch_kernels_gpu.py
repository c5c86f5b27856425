"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and numpy, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Without CUDA every test skips (the kernels have no CPU mode).  Shapes are
small and ragged (maps that are not multiples of the kernel's 8x8 tile) to
reach the edge handling that the main path's 64x64 and 128x128 maps do not.

Tolerance: both sides take the same bf16 matmul operands and accumulate in
f32; a summation-order ulp can flip one bf16-rounded depthwise output
(2^-8 relative) and bf16 outputs round once more: 2e-2 at outputs of order 1.
``fused_sepconv`` is held, as in chip_smoke.py, to 2e-3 ("mixed") and 1e-2
(bf16) of its largest output: at every launch shape of the Xception net
at output stride 16 and 8, at ragged maps and rates at and past the map's
size, and with each tile, chunk and pass width of ``sepconv_plan``
forced.  B2 is held to its plain version (``max_err_vs_plain``) at every
block shape of the net on its own map and two ragged ones, and its sums
repeat bit for bit at two more shapes.  F1 and F3 likewise, and at every
choice of their launch plans forced; on a 26x7 map each element of F2's
and B34's outputs over tolerance must trace to one eq at a bf16 rounding
boundary (C3: the tensor cores' sums are not a plain f32 order).

``fused_dw_bn_relu6`` is held to its plain version within 1e-5 (f32) and 2
bf16 ulps (bf16) of its largest output, at ragged maps and channel counts,
an odd C (one channel a thread) and a rate past the map; and bit for bit
(both sum the taps in f32 in one order, built with ``-fmad=false``) at
MobileNetV2 block 0's maps of 512x512, 384x384, 640x640 and 375x500
requests, 64x64x384 at rate 2, a C that is not a multiple of 4 and a ragged
map, f32 and bf16, at every strip width ``dw_plan`` may choose, forced.

The CRF kernels are held to their plain versions on the inputs the main path
gives them: a CRF run with the plain versions records every call, then each
kernel runs on the recorded inputs and is compared with the recorded output
(``crf_fused.plain_versions`` and ``max_err_vs_plain``, as chip_smoke.py
does; tolerances there: f32 outputs 1e-4 of the largest value, bf16 outputs
2 bf16 ulps, the step's Q 4 ulps).  The geometries: production (nc 15, stride 2), fast-faithful
(nc 13, stride 1), throughput (nc 9, stride 4) and faithful (nc 21, whose
blurred grid is too large for shared memory), with padded cells.  The
reference-API CRF the same way: ``slice_planes`` (tolerance 2 bf16 ulps)
and the splat through the XLA engine, the explicit-unary step through the
plane engine's ``mean_field``, each with exact launch counts.

The splat on flat, noise and structured cells at every label count and
grid size of the configs, both value types; the step in both forms (fused,
and two kernels) on the same recorded inputs, held to the plain version and
to each other bit for bit, at both strides, both unary forms and both
dispatches; a launch that fails or a plan the launcher rejects raises.

The spatial blur's y and x passes against their plain versions (2 bf16
ulps) at the VOC cell heights 75, 50 and 72, radii 20 and 32, ragged label
counts and both forms of gn, and bit for bit (both sum the taps in tap
order with exact products) at radii 8 to 128; the row kernel bit for bit
against the chained plain passes at every odd tap count and at the VOC
cell heights; ``gaussian_blur_planes`` dispatching to the row kernel (radii
up to 16, gn (Z, 1, P), any cell height) or to the two passes, read off the
launch counters; ``slice_planes`` against its plain version (2 bf16 ulps)
over both engine grid sizes, the norm pass's and the iterations' label
counts and ragged cells, and bit for bit against itself with every launch
form forced; and the CRF at a VOC geometry, at ``resolution_scale`` 2 and
at the notebook's sxy 16, each with exact launch counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crf_scenes import make_scene
from deeplab_tpu_torch import crf as CRF
from deeplab_tpu_torch.kernels import crf_fused as CK
from deeplab_tpu_torch.kernels import fused_dw as FDW
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _weights(r, Cin, Ce, Cout, dev):
    w = dict(w1=r.randn(Cin, Ce) * 0.2, b1=r.randn(Ce) * 0.1,
             wdw=r.randn(9, Ce) * 0.2, bdw=r.randn(Ce) * 0.1,
             w2=r.randn(Ce, Cout) * 0.1, b2=r.randn(Cout) * 0.1)
    w = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
         for k, v in w.items()}
    w["w1"], w["w2"] = w["w1"].bfloat16(), w["w2"].bfloat16()
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate,skip,Cin,Ce,Cout,H,W", [
    (1, True, 24, 144, 24, 20, 36),    # ragged tiles, Cin padded to 32
    (2, False, 32, 200, 64, 16, 13),   # Ce not a multiple of the chunk
    (4, True, 16, 96, 16, 8, 8),       # halo wider than the image
])
def test_cuda_kernel_matches_reference(cuda, x_dtype, rate, skip, Cin, Ce,
                                       Cout, H, W):
    r = np.random.RandomState(2)
    w = _weights(r, Cin, Ce, Cout, cuda)
    x = torch.from_numpy(r.randn(2, H, W, Cin).astype(np.float32))
    x = x.to(cuda, x_dtype)
    mxu = x_dtype == torch.float32
    before = FM.fused_mbconv.launches
    got = FM.fused_mbconv(x, **w, rate=rate, skip=skip, mxu_bf16=mxu)
    ref = FM.fused_mbconv_reference(x, **w, rate=rate, skip=skip,
                                    mxu_bf16=mxu)
    torch.cuda.synchronize()
    assert FM.fused_mbconv.launches == before + 1
    assert got.dtype == x_dtype and got.shape == (2, H, W, Cout)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    r = np.random.RandomState(3)
    w = _weights(r, 8, 48, 8, cuda)
    x = torch.zeros(1, 8, 8, 8, device=cuda)
    with pytest.raises(ValueError):   # f32 without mxu_bf16: no kernel mode
        FM.fused_mbconv(x, **w, rate=1, skip=True, mxu_bf16=False)
    with pytest.raises(ValueError):   # non-contiguous input
        FM.fused_mbconv(x.transpose(1, 2), **w, rate=1, skip=True,
                        mxu_bf16=True)


# the main path's fused block shapes (Cin, Ce, Cout, rate, skip): blocks 2,
# 4-5, 6, 7-9, 10, 11-12, 13, 14-15 and 16 of MobileNetV2
MAIN_PATH_BLOCKS = [(24, 144, 24, 1, True), (32, 192, 32, 1, True),
                    (32, 192, 64, 1, False), (64, 384, 64, 2, True),
                    (64, 384, 96, 2, False), (96, 576, 96, 2, True),
                    (96, 576, 160, 2, False), (160, 960, 160, 4, True),
                    (160, 960, 320, 4, False)]


def _mbconv_case(cuda, x_dtype, Cin, Ce, Cout, rate, skip, H, W, seed=5):
    r = np.random.RandomState(seed)
    w = _weights(r, Cin, Ce, Cout, cuda)
    x = torch.from_numpy(r.randn(2, H, W, Cin).astype(np.float32))
    x = x.to(cuda, x_dtype)
    mxu = x_dtype == torch.float32
    before = FM.fused_mbconv.launches
    got = FM.fused_mbconv(x, **w, rate=rate, skip=skip, mxu_bf16=mxu)
    ref = FM.fused_mbconv_reference(x, **w, rate=rate, skip=skip,
                                    mxu_bf16=mxu)
    torch.cuda.synchronize()
    assert FM.fused_mbconv.launches == before + 1
    assert got.dtype == x_dtype and got.shape == (2, H, W, Cout)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(37, 21), (26, 7)])
@pytest.mark.parametrize("block", MAIN_PATH_BLOCKS)
def test_cuda_kernel_at_main_path_shapes_and_ragged_maps(cuda, x_dtype, H, W,
                                                         block):
    """Each main-path channel shape on maps that no tile divides, one of
    them narrower than every tile."""
    _mbconv_case(cuda, x_dtype, *block, H, W)


@pytest.mark.gpu
@pytest.mark.parametrize("ck", FM.MBCONV_CHUNKS)
@pytest.mark.parametrize("tile", FM.MBCONV_TILES)
@pytest.mark.parametrize("block,H,W", [
    ((64, 384, 64, 2, True), 21, 19),
    ((96, 576, 96, 4, True), 19, 35),    # two stages at 16x16
    ((20, 100, 24, 2, False), 30, 17),   # Cin, Ce not multiples of 8
])
def test_cuda_kernel_at_each_tile(cuda, monkeypatch, ck, tile, block, H, W):
    """Each tile and chunk the plan can choose, forced, at ragged maps: its
    halo box clipped at every edge, its chunk ring (2 or 3 stages) and its
    accumulator layout."""
    Cin, Ce, Cout, rate, skip = block
    monkeypatch.setattr(FM, "MBCONV_TILES", (tile,))
    monkeypatch.setattr(FM, "MBCONV_CHUNKS", (ck,))
    FM.mbconv_plan.cache_clear()
    try:
        plan = FM.mbconv_plan(2, H, W, Cin, Ce, Cout, rate)
        assert (plan.th, plan.tw, plan.ck) == tile + (ck,)
        _mbconv_case(cuda, torch.float32, *block, H, W)
    finally:
        FM.mbconv_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("pre_relu", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cin,Cout,rate,H,W", [
    (728, 728, 1, 16, 16),      # middle flow: Cin = 22 chunks of 32 + 24
    (1536, 2048, 2, 12, 12),    # exit flow, the widest layer
    (2048, 256, 18, 32, 32),    # ASPP at OS 16: the rate passes the map
    (304, 256, 1, 128, 128),    # decoder: Cin = 9 chunks of 32 + 16
])
def test_sepconv_kernel_matches_reference(cuda, x_dtype, pre_relu, Cin, Cout,
                                          rate, H, W):
    r = np.random.RandomState(7)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (r.randn(*s) * sc).astype(np.float32)).to(cuda)
    wdw, bdw = t(9, Cin, sc=0.3), t(Cin, sc=0.1)
    wpw, bpw = t(Cin, Cout, sc=Cin ** -0.5).bfloat16(), t(Cout, sc=0.1)
    x = t(1, H, W, Cin).to(x_dtype)
    kw = dict(rate=rate, pre_relu=pre_relu, act_mid=not pre_relu,
              act_out=not pre_relu, mxu_bf16=x_dtype == torch.float32)
    before = FM.fused_sepconv.launches
    got = FM.fused_sepconv(x, wdw, bdw, wpw, bpw, **kw)
    ref = FM.fused_sepconv_reference(x, wdw, bdw, wpw, bpw, **kw)
    torch.cuda.synchronize()
    assert FM.fused_sepconv.launches == before + 1
    assert got.dtype == x_dtype and got.shape == (1, H, W, Cout)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 2e-3 if x_dtype == torch.float32 else 1e-2
    assert scale > 0 and err <= tol * scale, (err, scale)


# the stride-1 SepConv_BN launch shapes of the 512x512 Xception net at
# output stride 16 and 8: (Cin, Cout, rate, map side, pre_relu)
XCEPTION_SEPCONV = sorted({
    (64, 128, 1, 256, True), (128, 128, 1, 256, True),
    (128, 256, 1, 128, True), (256, 256, 1, 128, True),
    (256, 728, 1, 64, True), (728, 728, 1, 64, True),
    (728, 728, 1, 32, True), (728, 1024, 1, 32, True),
    (1024, 1024, 1, 32, True), (1024, 1536, 2, 32, False),
    (1536, 1536, 2, 32, False), (1536, 2048, 2, 32, False),
    (2048, 256, 6, 32, False), (2048, 256, 12, 32, False),
    (2048, 256, 18, 32, False), (304, 256, 1, 128, False),
    (256, 256, 1, 128, False), (728, 728, 2, 64, True),
    (728, 1024, 2, 64, True), (1024, 1024, 2, 64, True),
    (1024, 1536, 4, 64, False), (1536, 1536, 4, 64, False),
    (1536, 2048, 4, 64, False), (2048, 256, 12, 64, False),
    (2048, 256, 24, 64, False), (2048, 256, 36, 64, False)})


def _sepconv_case(cuda, x_dtype, Cin, Cout, rate, H, W, pre_relu, B=1,
                  seed=7):
    r = np.random.RandomState(seed)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (r.randn(*s) * sc).astype(np.float32)).to(cuda)
    wdw, bdw = t(9, Cin, sc=0.3), t(Cin, sc=0.1)
    wpw, bpw = t(Cin, Cout, sc=Cin ** -0.5).bfloat16(), t(Cout, sc=0.1)
    x = t(B, H, W, Cin).to(x_dtype)
    kw = dict(rate=rate, pre_relu=pre_relu, act_mid=not pre_relu,
              act_out=not pre_relu, mxu_bf16=x_dtype == torch.float32)
    before = FM.fused_sepconv.launches
    got = FM.fused_sepconv(x, wdw, bdw, wpw, bpw, **kw)
    ref = FM.fused_sepconv_reference(x, wdw, bdw, wpw, bpw, **kw)
    torch.cuda.synchronize()
    assert FM.fused_sepconv.launches == before + 1
    assert got.dtype == x_dtype and got.shape == (B, H, W, Cout)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 2e-3 if x_dtype == torch.float32 else 1e-2
    assert scale > 0 and err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", XCEPTION_SEPCONV)
def test_sepconv_at_every_xception_shape(cuda, x_dtype, shape):
    """Each launch shape of the Xception net at OS 16 and 8, B=2, under
    "mixed" (f32) and bf16: its plan as the net gets it."""
    Cin, Cout, rate, side, pre = shape
    _sepconv_case(cuda, x_dtype, Cin, Cout, rate, side, side, pre, B=2)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cin,Cout,rate,H,W", [
    (728, 728, 1, 37, 21),      # ragged tiles both ways
    (2048, 256, 36, 37, 21),    # rate past the map: the box is the tile
    (2048, 256, 24, 64, 64),    # rate between the map's half and its size
    (1536, 1536, 40, 19, 35),   # past the map, three passes of A
    (256, 728, 2, 26, 7),       # a map narrower than the tile
    (16, 24, 1, 8, 8),          # one partial chunk, one partial n-tile pair
])
def test_sepconv_at_ragged_maps_and_large_rates(cuda, x_dtype, Cin, Cout,
                                                rate, H, W):
    _sepconv_case(cuda, x_dtype, Cin, Cout, rate, H, W, False, B=2)
    _sepconv_case(cuda, x_dtype, Cin, Cout, rate, H, W, True, B=1)


@pytest.mark.gpu
@pytest.mark.parametrize("nt", [4, 8])
@pytest.mark.parametrize("ck", [64, 32, 16])
@pytest.mark.parametrize("Cin,Cout,rate,H,W", [
    (728, 728, 1, 21, 19), (1024, 1536, 2, 19, 35), (2048, 256, 18, 32, 32),
    (304, 256, 1, 37, 21), (1536, 2048, 2, 26, 7)])
def test_sepconv_at_each_plan(cuda, monkeypatch, ck, nt, Cin, Cout, rate, H,
                              W):
    """Each chunk and pass width the plan may choose, forced (the plan
    picks Cout groups and ring), where it fits shared memory."""
    tile = (8, 8)
    monkeypatch.setattr(FM, "SEPCONV_CHUNKS", (ck,))
    monkeypatch.setattr(FM, "SEPCONV_NT", (nt,))
    FM.sepconv_plan.cache_clear()
    try:
        for x_dtype in (torch.float32, torch.bfloat16):
            try:
                p = FM.sepconv_plan(1, H, W, Cin, Cout, rate,
                                    x_dtype == torch.bfloat16)
            except ValueError:
                continue
            assert (p.th, p.tw, p.ck, p.nt) == tile + (ck, nt)
            _sepconv_case(cuda, x_dtype, Cin, Cout, rate, H, W, False)
    finally:
        FM.sepconv_plan.cache_clear()


@pytest.mark.gpu
def test_sepconv_wrapper_raises_instead_of_falling_back(cuda, monkeypatch):
    wdw = torch.zeros(9, 16, device=cuda)
    bdw = torch.zeros(16, device=cuda)
    wpw = torch.zeros(16, 24, device=cuda, dtype=torch.bfloat16)
    bpw = torch.zeros(24, device=cuda)
    x = torch.zeros(1, 8, 8, 16, device=cuda)
    kw = dict(rate=1, pre_relu=True, act_mid=False, act_out=False)
    before = FM.fused_sepconv.launches
    with pytest.raises(ValueError):   # f32 without mxu_bf16: no kernel mode
        FM.fused_sepconv(x, wdw, bdw, wpw, bpw, **kw)

    class FailedLaunch:               # the library reports a launch error
        @staticmethod
        def fused_sepconv_launch(*args):
            return 9                  # cudaErrorInvalidConfiguration

        @staticmethod
        def fused_sepconv_error(code):
            return b"invalid configuration argument"
    monkeypatch.setattr(FM, "_lib", lambda name: FailedLaunch)
    with pytest.raises(RuntimeError, match="launch failed"):
        FM.fused_sepconv(x, wdw, bdw, wpw, bpw, mxu_bf16=True, **kw)
    assert FM.fused_sepconv.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name,H,W,L", [
    ("PRODUCTION_CONFIG", 128, 256, 21),
    ("FAST_FAITHFUL_CONFIG", 80, 120, 11),
    ("THROUGHPUT_CONFIG", 96, 200, 21),
    ("FAITHFUL_CONFIG", 64, 256, 21),
])
def test_crf_kernels_match_reference(cuda, name, H, W, L):
    scenes = [make_scene(H, W, L, seed) for seed in (1, 2)]
    imgs = torch.from_numpy(np.stack([s[0] for s in scenes])).to(cuda)
    masks = torch.from_numpy(np.stack([s[1] for s in scenes])).to(cuda)
    with CK.plain_versions() as calls:
        CRF.mean_field_batched(imgs, masks, getattr(CRF, name), L)
    for kname in CK.KERNELS:
        kernel = getattr(CK, kname)
        assert calls[kname], kname
        for args, kw, want in calls[kname]:
            before = kernel.launches
            got = kernel(*args, **kw)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            err, ok = CK.max_err_vs_plain(kname, got, want)
            assert ok, (kname, err)


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [2.0, 3.0, 6.0])
def test_blur_kernel_matches_reference_at_each_radius(cuda, sigma):
    """Radius 5 (odd: the halo tile's row pitch is padded to 4 floats), 8
    (the main path's) and 15, on 2x2 cells of 64x128 with a ragged L."""
    taps = tuple(float(t) for t in CRF.dense_crf._gauss_taps(sigma))
    r = np.random.RandomState(4)
    B, ny, nx, cs_y, cs_x, L = 2, 2, 2, 64, 128, 7
    Z, P = ny * nx, cs_y * cs_x
    q = torch.from_numpy(r.rand(B * Z, L, P).astype(np.float32))
    gn = torch.from_numpy(0.5 + r.rand(Z, 1, P).astype(np.float32))
    q, gn = q.to(cuda, torch.bfloat16), gn.to(cuda)
    kw = dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    before = CK.gaussian_blur_planes.launches
    got = CK.gaussian_blur_planes(q, gn, **kw)
    want = CK.gaussian_blur_planes_reference(q, gn, **kw)
    torch.cuda.synchronize()
    assert CK.gaussian_blur_planes.launches == before + 1
    err, ok = CK.max_err_vs_plain("gaussian_blur_planes", got, want)
    assert ok, (sigma, len(taps), err)


@pytest.mark.gpu
def test_crf_wrappers_raise_instead_of_falling_back(cuda):
    a = torch.zeros(2, 3, 8 * 128, device=cuda)       # f32: not a Q state
    gn = torch.ones(1, 1, 8 * 128, device=cuda)
    with pytest.raises(ValueError):
        CK.gaussian_blur_planes(a, gn, taps=(0.5, 1.0, 0.5), B=2, ny=1,
                                nx=1, cs_y=8, cs_x=128)
    rgb = torch.zeros(4, 3, 64, device=cuda)
    with pytest.raises(ValueError):                   # bf16 values, f32 grid
        CK.splat_planes(rgb, torch.zeros(4, 2, 64, device=cuda,
                                         dtype=torch.bfloat16),
                        nc=15, L=2, inv_step=1 / 19.5)


# (B, ny, nx, cs_y, cs_x, L, sigma, gn per image): the VOC cell heights at
# r = 8, radii 20 and 32 on 64x128 cells, a ragged L, both forms of gn
BLUR_PASS_SHAPES = [(2, 5, 4, 75, 128, 21, 3.0, False),
                    (2, 10, 3, 50, 128, 7, 3.0, True),
                    (1, 5, 4, 72, 128, 21, 3.0, False),
                    (2, 2, 2, 64, 128, 5, 8.0, True),
                    (2, 2, 2, 64, 128, 3, 12.5, False),
                    (3, 2, 3, 30, 40, 4, 4.0, False)]


def _blur_case(cuda, B, ny, nx, cs_y, cs_x, L, sigma, per_image, seed=6):
    taps = tuple(float(t) for t in CRF.dense_crf._gauss_taps(sigma))
    r = np.random.RandomState(seed)
    Z, P = ny * nx, cs_y * cs_x
    q = torch.from_numpy(r.rand(B * Z, L, P).astype(np.float32))
    gn = torch.from_numpy(0.5 + r.rand(B * Z if per_image else Z, 1, P)
                          .astype(np.float32))
    kw = dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    return q.to(cuda, torch.bfloat16), gn.to(cuda), kw


def _blur_counts():
    return tuple(getattr(CK, n).launches for n in (
        "gaussian_blur_planes",) + CK.BLUR_PASSES)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BLUR_PASS_SHAPES)
def test_blur_passes_match_reference(cuda, shape):
    q, gn, kw = _blur_case(cuda, *shape)
    before = _blur_counts()
    y = CK.gaussian_blur_y_planes(q, gn, **kw)
    y_ref = CK.gaussian_blur_y_planes_reference(q, gn, **kw)
    x = CK.gaussian_blur_x_planes(y_ref, **kw)
    x_ref = CK.gaussian_blur_x_planes_reference(y_ref, **kw)
    torch.cuda.synchronize()
    assert _blur_counts() == (before[0], before[1] + 1, before[2] + 1)
    for name, got, want in (("gaussian_blur_y_planes", y, y_ref),
                            ("gaussian_blur_x_planes", x, x_ref)):
        err, ok = CK.max_err_vs_plain(name, got, want)
        assert ok, (name, shape, err)
    # the dispatch: the row kernel where its radius and gn form fit (the
    # VOC heights at r = 8, any height), else the two passes
    rows = CK.row_kernel_fits(kw["taps"], kw["cs_x"], shape[-1])
    before = _blur_counts()
    out = CK.gaussian_blur_planes(q, gn, **kw)
    torch.cuda.synchronize()
    assert _blur_counts() == ((before[0] + 1, before[1], before[2]) if rows
                              else (before[0], before[1] + 1, before[2] + 1))
    err, ok = CK.max_err_vs_plain(
        "gaussian_blur_planes", out,
        CK.gaussian_blur_planes_reference(q, gn, **kw))
    assert ok, (shape, err)


@pytest.mark.gpu
def test_row_kernel_where_its_geometry_fits(cuda):
    q, gn, kw = _blur_case(cuda, 2, 2, 2, 64, 128, 7, 3.0, False)
    assert CK.row_kernel_fits(kw["taps"], 128)
    before = _blur_counts()
    out = CK.gaussian_blur_planes(q, gn, **kw)
    torch.cuda.synchronize()
    assert _blur_counts() == (before[0] + 1, before[1], before[2])
    err, ok = CK.max_err_vs_plain(
        "gaussian_blur_planes", out,
        CK.gaussian_blur_planes_reference(q, gn, **kw))
    assert ok, err
    # one gn plane per cell, the form the row kernel does not take: the
    # two passes run instead, and the row kernel launched directly raises
    _, gn_cells, _ = _blur_case(cuda, 2, 2, 2, 64, 128, 7, 3.0, True)
    before = _blur_counts()
    out = CK.gaussian_blur_planes(q, gn_cells, **kw)
    torch.cuda.synchronize()
    assert _blur_counts() == (before[0], before[1] + 1, before[2] + 1)
    err, ok = CK.max_err_vs_plain(
        "gaussian_blur_planes", out,
        CK.gaussian_blur_planes_reference(q, gn_cells, **kw))
    assert ok, err
    with pytest.raises(ValueError):
        CK.blur_rows(q, gn_cells, **kw)
    assert _blur_counts() == (before[0], before[1] + 1, before[2] + 1)


@pytest.mark.gpu
def test_blur_pass_wrappers_raise_instead_of_falling_back(cuda):
    q, gn, kw = _blur_case(cuda, 1, 2, 2, 24, 128, 3, 3.0, False)
    before = _blur_counts()
    with pytest.raises(ValueError):                   # f32: not a Q state
        CK.gaussian_blur_y_planes(q.float(), gn, **kw)
    with pytest.raises(ValueError):
        CK.gaussian_blur_x_planes(q.float(), **kw)
    with pytest.raises(ValueError):                   # gn of 3 planes
        CK.gaussian_blur_y_planes(q, gn[:3], **kw)
    with pytest.raises(ValueError):                   # radius 30 > 24 rows
        CK.gaussian_blur_y_planes(q, gn, **dict(kw, taps=(0.5,) * 61))
    with pytest.raises(ValueError):                   # an even tap count
        CK.gaussian_blur_x_planes(q, **dict(kw, taps=(0.5, 1.0)))
    with pytest.raises(ValueError):                   # not the cells' size
        CK.gaussian_blur_x_planes(q, **dict(kw, cs_y=12))
    assert _blur_counts() == before


# (B, ny, nx, cs_y, cs_x, L, taps, gn per image): radii 17, 20, 32 and 64
# (the generic instantiation, and r = 20's own), r = 8 (17 taps, generic)
# with gn per cell, a ragged L, both forms of gn, a width that is not a
# multiple of 8 (element-wise staging and stores), 128-row cells that the
# y pass splits into strips at r = 128
PASS_CASES = [(2, 2, 2, 64, 128, 5, 35, False), (2, 2, 2, 64, 128, 7, 41, True),
              (1, 2, 2, 64, 128, 3, 65, False), (2, 1, 2, 80, 128, 3, 129, True),
              (2, 5, 4, 75, 128, 21, 17, True), (2, 2, 3, 48, 36, 3, 35, False),
              (1, 2, 2, 128, 128, 2, 257, False),
              (8, 8, 4, 64, 128, 21, 41, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PASS_CASES)
def test_blur_passes_equal_their_plain_versions(cuda, case):
    """Each redesigned pass sums its taps in tap order with exact products,
    as its plain version: equal bit for bit (the x pass on the y pass's
    plain output, so both sides take the same input)."""
    B, ny, nx, cs_y, cs_x, L, n, per_image = case
    taps = _taps(n)
    r = np.random.RandomState(9)
    Z, P = ny * nx, cs_y * cs_x
    q = torch.from_numpy(r.rand(B * Z, L, P).astype(np.float32)).to(
        cuda, torch.bfloat16)
    gn = torch.from_numpy(0.5 + r.rand(B * Z if per_image else Z, 1, P)
                          .astype(np.float32)).to(cuda)
    kw = dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    before = _blur_counts()
    y = CK.gaussian_blur_y_planes(q, gn, **kw)
    y_ref = CK.gaussian_blur_y_planes_reference(q, gn, **kw)
    x = CK.gaussian_blur_x_planes(y_ref, **kw)
    x_ref = CK.gaussian_blur_x_planes_reference(y_ref, **kw)
    torch.cuda.synchronize()
    assert _blur_counts() == (before[0], before[1] + 1, before[2] + 1)
    assert torch.equal(y, y_ref), (y.float() - y_ref.float()).abs().max()
    assert torch.equal(x, x_ref), (x.float() - x_ref.float()).abs().max()


def _slice_case(cuda, nc, L, Z, P, seed=10):
    """Seeded XLA-engine inputs of slice_planes: rgb planes 0-255 and a
    z-blurred f32 grid of the splat's magnitude; the color taps and step of
    the config with that grid size."""
    cfg = CRF.FAITHFUL_CONFIG if nc == 21 else CRF.PRODUCTION_CONFIG
    ctaps = tuple(float(t) for t in CRF.dense_crf._cfg_color_taps(cfg))
    r = np.random.RandomState(seed)
    rgb = torch.from_numpy((r.rand(Z, 3, P) * 255).astype(np.float32))
    grid = torch.from_numpy((r.rand(Z, nc * L, nc * nc) * 40)
                            .astype(np.float32))
    kw = dict(nc=nc, L=L, inv_step=1.0 / (cfg.srgb * cfg.color_step),
              ctaps=ctaps)
    return rgb.to(cuda), grid.to(cuda), kw


@pytest.mark.gpu
@pytest.mark.parametrize("nc", [15, 21])
@pytest.mark.parametrize("L", [1, 2, 5, 21])
@pytest.mark.parametrize("Z,P", [(49, 6400), (1, 6400), (1, 225),
                                 (4, 256)])
def test_slice_planes_sweep(cuda, nc, L, Z, P):
    """The fused slice_planes against its plain version (2 bf16 ulps of
    the largest value) at both engine grid sizes, the label counts of the
    norm pass and the iterations, one cell and an image's 49, and ragged
    cells (15x15, 16x16)."""
    rgb, grid, kw = _slice_case(cuda, nc, L, Z, P)
    before = CK.slice_planes.launches
    got = CK.slice_planes(rgb, grid, **kw)
    want = CK.slice_planes_reference(rgb, grid, **kw)
    torch.cuda.synchronize()
    assert CK.slice_planes.launches == before + 1
    err, ok = CK.max_err_vs_plain("slice_planes", got, want)
    assert ok, (nc, L, Z, P, err, CK.slice_plan(Z, P, L, nc))


@pytest.mark.gpu
@pytest.mark.parametrize("nc", [15, 21])
def test_slice_planes_every_form_and_group_size(cuda, monkeypatch, nc):
    """Every block form of slice_plan (S padded or not), every label group
    size and one or two of its labels a blur round, where they fit, forced:
    outputs equal the plan's bit for bit (one blur order, one slice order)
    and within tolerance of the plain version."""
    L, Z, P = 5, 3, 6400
    rgb, grid, kw = _slice_case(cuda, nc, L, Z, P, seed=11)
    want = CK.slice_planes(rgb, grid, **kw)
    plain = CK.slice_planes_reference(rgb, grid, **kw)
    real = CK.slice_plan(Z, P, L, nc)
    for lg in range(1, L + 1):
        for lb in range(1, min(lg, CK.SLICE_LB) + 1):
            for pad in (True, False):
                smem = CK.slice_smem(nc, L, lg, lb, pad)
                if smem > CK.BLUR_SMEM_LIMIT:
                    continue
                plan = dataclasses.replace(
                    real, lg=lg, groups=-(-L // lg), lb=lb,
                    lgp=CK.slice_lgp(lg), pad=pad, splits=2, smem=smem)
                monkeypatch.setattr(CK, "slice_plan", lambda *a, p=plan: p)
                got = CK.slice_planes(rgb, grid, **kw)
                torch.cuda.synchronize()
                monkeypatch.undo()
                assert torch.equal(got, want), (lg, lb, pad)
    err, ok = CK.max_err_vs_plain("slice_planes", want, plain)
    assert ok, err


@pytest.mark.gpu
def test_slice_and_passes_raise_instead_of_falling_back(cuda, monkeypatch):
    """A plan the launcher does not reproduce raises; the counts do not
    move and no plain version runs in the kernel's place."""
    rgb, grid, kw = _slice_case(cuda, 15, 5, 2, 256)
    real = CK.slice_plan(2, 256, 5, 15)
    monkeypatch.setattr(CK, "slice_plan", lambda *a: dataclasses.replace(
        real, smem=real.smem + 16))
    before = CK.slice_planes.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        CK.slice_planes(rgb, grid, **kw)
    assert CK.slice_planes.launches == before
    q, gn, bkw = _blur_case(cuda, 1, 2, 2, 64, 128, 3, 8.0, False)
    for wrong in ("ty", "threads"):
        for y_pass in (True, False):
            real = CK.pass_plan(1, 2, 2, 64, 128, 3, len(bkw["taps"]),
                                y_pass)
            bad = dataclasses.replace(
                real, **{wrong: getattr(real, wrong) + (1 if wrong == "ty"
                                                        else 16)})
            monkeypatch.setattr(CK, "pass_plan", lambda *a: bad)
            before = _blur_counts()
            with pytest.raises(RuntimeError, match="launch failed"):
                if y_pass:
                    CK.gaussian_blur_y_planes(q, gn, **bkw)
                else:
                    CK.gaussian_blur_x_planes(q, **bkw)
            assert _blur_counts() == before
    monkeypatch.undo()


def _taps(n):
    r = n // 2
    t = np.exp(-0.5 * ((np.arange(n) - r) / (0.4 * r + 0.5)) ** 2)
    return tuple(float(v) for v in t / t.sum())


# (B, ny, nx, cs_y, cs_x, L, taps): every odd tap count on 64x128 cells;
# cell heights 16, 48 and 128 with a ragged L; the VOC cell heights 75
# (375 rows), 50 (500), 72 (360) and 60 at r = 8 with gn (Z, 1, P), heights
# that are not a multiple of the y pass's 16-row windows; widths that are
# not a multiple of 8 (elementwise staging, 4 outputs a thread); the
# production input (8, 512, 512) at L = 21
ROW_BLUR_CASES = ([(2, 2, 2, 64, 128, 5, n) for n in range(3, 34, 2)]
                  + [(2, 3, 2, cs, 128, 7, 17) for cs in (16, 48, 128)]
                  + [(2, 5, 4, 75, 128, 21, 17), (2, 10, 3, 50, 128, 7, 17),
                     (1, 5, 4, 72, 128, 21, 17), (2, 2, 3, 60, 128, 5, 17)]
                  + [(2, 2, 3, 32, 36, 3, 9), (1, 2, 2, 48, 40, 4, 17)]
                  + [(8, 8, 4, 64, 128, 21, 17)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ROW_BLUR_CASES)
def test_row_kernel_equals_the_chained_passes(cuda, case):
    """The row kernel sums in tap order with exact products, as the y and x
    plain versions do: equal to their chain bit for bit, and within the
    existing tolerance of the fused plain version (F.conv2d's order)."""
    B, ny, nx, cs_y, cs_x, L, n = case
    taps = _taps(n)
    assert CK.row_kernel_fits(taps, cs_x)
    r = np.random.RandomState(8)
    Z, P = ny * nx, cs_y * cs_x
    q = torch.from_numpy(r.rand(B * Z, L, P).astype(np.float32)).to(
        cuda, torch.bfloat16)
    gn = torch.from_numpy(0.5 + r.rand(Z, 1, P).astype(np.float32)).to(cuda)
    kw = dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    before = _blur_counts()
    got = CK.gaussian_blur_planes(q, gn, **kw)
    torch.cuda.synchronize()
    assert _blur_counts() == (before[0] + 1, before[1], before[2])
    chain = CK.gaussian_blur_x_planes_reference(
        CK.gaussian_blur_y_planes_reference(q, gn, **kw), **kw)
    assert torch.equal(got, chain), (got.float() - chain.float()).abs().max()
    err, ok = CK.max_err_vs_plain(
        "gaussian_blur_planes", got,
        CK.gaussian_blur_planes_reference(q, gn, **kw))
    assert ok, (case, err)


def _crf_counts():
    return {n: getattr(CK, n).launches
            for n in CK.KERNELS + CK.BLUR_PASSES}


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,H,W,L,blur", [
    # cs_y = 75: the row kernel, no y or x pass
    (CRF.PRODUCTION_CONFIG, 150, 200, 11, "rows"),
    # 32x40 cells at half resolution: the image-layout blur, no blur kernel
    (dataclasses.replace(CRF.PRODUCTION_CONFIG, resolution_scale=2), 128,
     256, 21, "image"),
    (CRF.CrfConfig(sxy_bilateral=16.0), 64, 96, 5, "image"),
    (CRF.CrfConfig(sxy_gaussian=8.0), 128, 256, 5, "passes"),
])
def test_crf_geometries_match_reference(cuda, cfg, H, W, L, blur):
    scenes = [make_scene(H, W, L, seed) for seed in (1, 2)]
    imgs = torch.from_numpy(np.stack([s[0] for s in scenes])).to(cuda)
    masks = torch.from_numpy(np.stack([s[1] for s in scenes])).to(cuda)
    with CK.plain_versions() as calls:
        want = CRF.mean_field_batched(imgs, masks, cfg, L)
    for kname in CK.KERNELS:
        for args, kw, out in calls[kname]:
            got = getattr(CK, kname)(*args, **kw)
            torch.cuda.synchronize()
            err, ok = CK.max_err_vs_plain(kname, got, out)
            assert ok, (kname, err)
    before = _crf_counts()
    got = CRF.mean_field_batched(imgs, masks, cfg, L)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in _crf_counts().items()}
    n = cfg.n_iters
    passes = n if blur == "passes" else 0
    assert moved == {"splat_planes": n + 1, "slice_attrs_planes": 1,
                     "gaussian_blur_planes": n if blur == "rows" else 0,
                     "mf_step_planes": n,
                     "gaussian_blur_y_planes": passes,
                     "gaussian_blur_x_planes": passes}, moved
    assert got.shape == masks.shape
    agree = (got == want).float().mean().item()
    assert agree >= 0.99, agree


def _train_block_calls(dev, rate, skip, Cin, Ce, Cout, H, W, B=2, seed=5):
    """Run one training block forward and backward with the plain versions
    on ``dev``; returns the recorded {phase: [(args, kw, out)]}."""
    r = np.random.RandomState(seed)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (r.randn(*s) * sc).astype(np.float32)).to(dev)
    x = t(B, H, W, Cin).to(torch.bfloat16).requires_grad_()
    w = [t(Cin, Ce, sc=0.3), 1 + t(Ce, sc=0.1), t(Ce, sc=0.1),
         t(9, Ce, sc=0.3), 1 + t(Ce, sc=0.1), t(Ce, sc=0.1),
         t(Ce, Cout, sc=0.2), 1 + t(Cout, sc=0.1), t(Cout, sc=0.1)]
    w = [v.requires_grad_() for v in w]
    with FMT.plain_versions() as calls:
        out, _ = FMT.block_train(x, *w, rate=rate, skip=skip)
        (out.float() * t(B, H, W, Cout)).sum().backward()
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("rate,skip,Cin,Ce,Cout,H,W", [
    (1, True, 24, 144, 24, 20, 36),    # ragged tiles and pixel groups
    (2, False, 32, 200, 64, 16, 13),   # Ce not a multiple of the chunk
    (4, True, 16, 96, 16, 8, 8),       # halo wider than the map
    (4, False, 160, 960, 320, 16, 16),  # the widest block of the net
])
def test_train_phase_kernels_match_reference(cuda, rate, skip, Cin, Ce, Cout,
                                             H, W):
    calls = _train_block_calls(cuda, rate, skip, Cin, Ce, Cout, H, W)
    for name in FMT.PHASES:
        kernel = getattr(FMT, name)
        assert len(calls[name]) == 1, name
        args, kw, want = calls[name][0]
        before = kernel.launches
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        err, rel, ok = FMT.max_err_vs_plain(got, want)
        assert ok, (name, err, rel)


# the training block's shapes on the 512x512 net: (Cin, Ce, Cout, rate,
# skip, map side)
TRAIN_BLOCKS = [(24, 144, 24, 1, True, 128), (32, 192, 32, 1, True, 64),
                (32, 192, 64, 1, False, 64), (64, 384, 64, 2, True, 64),
                (64, 384, 96, 2, False, 64), (96, 576, 96, 2, True, 64),
                (96, 576, 160, 2, False, 64), (160, 960, 160, 4, True, 64),
                (160, 960, 320, 4, False, 64)]


def _halo_phases_match(dev, rate, skip, Cin, Ce, Cout, H, W,
                       explain=False):
    """F2 and B34 against their plain versions; with ``explain``, elements
    over tolerance pass where an eq at a bf16 rounding boundary explains
    each of them (``FMT.unexplained``, the rule chip_smoke.py's training
    check applies too)."""
    calls = _train_block_calls(dev, rate, skip, Cin, Ce, Cout, H, W)
    for name in ("f2", "b34"):
        args, kw, want = calls[name][0]
        kernel = getattr(FMT, name)
        before = kernel.launches
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        err, rel, ok = FMT.max_err_vs_plain(got, want)
        if explain and not ok:
            bad, _ = FMT.unexplained(name, args, kw, got, want)
            assert not bad, (name, err, rel, bad)
        else:
            assert ok, (name, err, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(None, None), (37, 21), (19, 35), (26, 7)])
@pytest.mark.parametrize("block", TRAIN_BLOCKS)
def test_halo_phases_at_every_block_shape(cuda, block, H, W):
    """F2 and B34 at each block shape of the net, B=2: on its own map, and
    on three ragged maps that no tile divides.  On the 26x7 map (364
    pixels) the 960-wide block's U2 differs from the plain version's at
    two channels by one bf16 rounding of eq: the tensor cores add an mma's
    16 products in their own way, which no plain f32 order reproduces
    (PERF.md, C3).  There every element over tolerance must trace to one
    eq near a bf16 rounding boundary whose other rounding, in the plain
    version, reproduces the kernel's element (``FMT.unexplained``), and none
    may pass FLIP_REL; FLIP_* stay as they are."""
    Cin, Ce, Cout, rate, skip, side = block
    H, W = (side, side) if H is None else (H, W)
    _halo_phases_match(cuda, rate, skip, Cin, Ce, Cout, H, W,
                       explain=(H, W) == (26, 7))


@pytest.mark.gpu
def test_f3_sums_follow_no_plain_order(cuda):
    """C3, measured (the counts show with pytest -s): F3's y_raw = q(b @
    w2) at the widest block (960 -> 320) on a 16 x 64 x 64 batch against
    plain orders of the same f32 sum of products: one f32 product (the
    plain version), f32 partial sums of each 16-deep k-step added in k
    order, the float64 sum rounded once, and float64 k-steps added to an
    f32 accumulator rounded toward zero or to nearest after each step.
    None reproduces the tensor cores' sums bit for bit; k-steps cut toward
    zero come closest."""
    calls = _train_block_calls(cuda, 4, False, 160, 960, 320, 64, 64, B=16)
    dq, a2, c2, w2 = calls["f3"][0][0]
    del calls
    with torch.no_grad():
        y = FMT.f3(dq, a2, c2, w2).reshape(-1, 320)
        Ce, q = dq.shape[-1], FMT._q(torch.bfloat16)
        b = FMT._relu6(q(q(dq.reshape(-1, Ce).float() * a2) + c2)).float()
        w = w2.float()
        orders = {"one f32 product": b @ w}
        acc = torch.zeros_like(orders["one f32 product"])
        for k0 in range(0, Ce, 16):
            acc = acc + b[:, k0:k0 + 16] @ w[k0:k0 + 16]
        orders["f32 k-steps in k order"] = acc
        b64, w64 = b.double(), w.double()
        orders["float64, rounded once"] = (b64 @ w64).float()
        for mode in ("toward zero", "to nearest"):
            acc = torch.zeros_like(orders["one f32 product"])
            for k0 in range(0, Ce, 16):
                exact = acc.double() + b64[:, k0:k0 + 16] @ w64[k0:k0 + 16]
                r = exact.float()
                if mode == "toward zero":
                    over = r.double().abs() > exact.abs()
                    r = torch.where(over, torch.nextafter(
                        r, torch.zeros_like(r)), r)
                acc = r
            orders[f"float64 k-steps, f32 {mode}"] = acc
        counts = {what: int((v.bfloat16() != y).sum().item())
                  for what, v in orders.items()}
    for what, n in counts.items():
        print(f"C3: F3 y_raw 960->320 on 16x64x64, bf16 elements differing "
              f"from {what}: {n} of {y.numel()}")
    assert min(counts.values()) > 0
    assert counts["float64 k-steps, f32 toward zero"] == min(counts.values())


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(None, None), (37, 21), (26, 7)])
@pytest.mark.parametrize("block", TRAIN_BLOCKS)
def test_f1_f3_at_every_block_shape(cuda, block, H, W):
    """F1 and F3 at each block shape of the net, B=2, on its own map and on
    two ragged ones (pixel counts that are not multiples of F1's 64-pixel
    tile or F3's 128-pixel block), with the plans train_plan chooses; F3
    also with w2 as the net holds it (the transpose of a contiguous
    (Cout, Ce) tensor, which the kernel reads without a copy), equal bit
    for bit."""
    Cin, Ce, Cout, rate, skip, side = block
    H, W = (side, side) if H is None else (H, W)
    calls = _train_block_calls(cuda, rate, skip, Cin, Ce, Cout, H, W)
    for name in ("f1", "f3"):
        args, kw, want = calls[name][0]
        kernel = getattr(FMT, name)
        before = kernel.launches
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        err, rel, ok = FMT.max_err_vs_plain(got, want)
        assert ok, (name, err, rel)
        if name == "f3":
            w2t = args[3].t().contiguous().t()
            assert torch.equal(kernel(*args[:3], w2t), got)


@pytest.mark.gpu
def test_f3_with_an_affine_that_is_not_bf16(cuda):
    """The block rounds BN2's scale and shift to bf16, and F3 then runs its
    prologue in bf16x2 arithmetic; other a2, c2 take its f32 arithmetic,
    which must still match the plain version."""
    calls = _train_block_calls(cuda, 1, False, 32, 200, 168, 19, 13)
    (dq, a2, c2, w2), _, _ = calls["f3"][0]
    a2, c2 = a2 * (1 + 2.0 ** -12), c2 + 2.0 ** -14
    assert not torch.equal(a2.bfloat16().float(), a2)
    want = FMT.f3_reference(dq, a2, c2, w2)
    err, rel, ok = FMT.max_err_vs_plain(FMT.f3(dq, a2, c2, w2), want)
    assert ok, (err, rel)


def _forced(FMT, monkeypatch, **choices):
    for k, v in choices.items():
        monkeypatch.setattr(FMT, k, v)
    FMT.train_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("case", FMT.F3_CASES)
def test_f3_at_each_plan(cuda, monkeypatch, case, stages):
    """Each warpgroup width and column groups (``F3_CASES``) and ring F3's
    plan can choose, forced, at Ce 200 (the last chunk of 64 ragged), Cout
    168 (the last split of Cout ragged, or a warpgroup's columns past Cout)
    and 494 pixels (the last block ragged).  A ring that does not fit is
    refused."""
    nt, cw = case
    _forced(FMT, monkeypatch, F3_CASES=(case,), F3_STAGES=(stages,))
    try:
        if FMT.f3_smem(200, nt, cw, stages) > FM.SMEM_LIMIT:
            with pytest.raises(ValueError):
                FMT.train_plan("f3", 2, 19, 13, 8, 200, 168, 1)
            return
        p = FMT.train_plan("f3", 2, 19, 13, 8, 200, 168, 1)
        assert (p.nt, p.th, p.tw, p.stages) == (nt, FMT.F3_PM, cw, stages)
        assert p.splits == -(-168 // FMT._f3_cols(nt, cw))
        calls = _train_block_calls(cuda, 1, False, 32, 200, 168, 19, 13)
        args, kw, want = calls["f3"][0]
        err, rel, ok = FMT.max_err_vs_plain(FMT.f3(*args, **kw), want)
        assert ok, (err, rel)
    finally:
        FMT.train_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("wgs", FMT.F1_WGS)
@pytest.mark.parametrize("Cin,Ce", [(40, 200), (160, 960)])
def test_f1_at_each_plan(cuda, monkeypatch, wgs, Cin, Ce):
    """Each warpgroup count F1's plan can choose, forced: at Cin 40 (padded
    to 64 with zeros) and Ce 200 (the last channel chunk ragged), and at
    the widest block, both on 494 pixels (the last tile ragged)."""
    _forced(FMT, monkeypatch, F1_WGS=(wgs,))
    try:
        p = FMT.train_plan("f1", 2, 19, 13, Cin, Ce, 8, 1)
        assert p.ck == 64 * wgs
        calls = _train_block_calls(cuda, 1, False, Cin, Ce, 24, 19, 13)
        args, kw, want = calls["f1"][0]
        err, rel, ok = FMT.max_err_vs_plain(FMT.f1(*args, **kw), want)
        assert ok, (err, rel)
    finally:
        FMT.train_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("ck", [32, 16])
@pytest.mark.parametrize("tile", [(16, 16), (8, 16), (8, 8)])
@pytest.mark.parametrize("block,H,W", [
    ((24, 144, 24, 1, True), 20, 36),
    ((64, 384, 64, 2, True), 21, 19),
    ((96, 576, 96, 4, True), 19, 35),
    ((160, 960, 160, 4, False), 19, 35),   # the widest: some tiles refused
    ((32, 200, 64, 2, False), 16, 13),     # Ce not a multiple of the chunk
])
def test_halo_phases_at_each_tile(cuda, monkeypatch, ck, tile, block, H, W):
    """Each tile and chunk train_plan can choose, forced, for F2 and B34 at
    ragged maps: the halo box clipped at every edge, the ring, the dx
    accumulator layout.  A tile the plan cannot take (shared memory, or no
    instantiated accumulator) is refused there with ValueError."""
    Cin, Ce, Cout, rate, skip = block
    monkeypatch.setattr(FMT, "TRAIN_TILES", (tile,))
    monkeypatch.setattr(FMT, "TRAIN_CHUNKS", (ck,))
    FMT.train_plan.cache_clear()
    try:
        fits = {}
        for phase in ("f2", "b34"):
            try:
                p = FMT.train_plan(phase, 2, H, W, Cin, Ce, 8, rate)
                assert (p.th, p.tw, p.ck) == tile + (ck,)
                fits[phase] = True
            except ValueError:
                fits[phase] = False
        assert fits["f2"] or not fits["b34"]   # B34 needs more than F2
        if fits["b34"]:
            _halo_phases_match(cuda, rate, skip, Cin, Ce, Cout, H, W)
        elif fits["f2"]:
            calls = _train_block_calls(cuda, rate, skip, Cin, Ce, Cout, H, W)
            args, kw, want = calls["f2"][0]
            assert FMT.max_err_vs_plain(FMT.f2(*args, **kw), want)[2]
    finally:
        FMT.train_plan.cache_clear()


@pytest.mark.gpu
def test_train_phase_sums_repeat_bit_for_bit(cuda):
    """Per-block partials and a fixed-order second pass: no atomics.  B2's
    T1, T2, dW2 (and ddh), F1's sums and F3's y_raw also at the widest
    block and at 576->160, whose chunks, splits and Cout splits differ."""
    calls = _train_block_calls(cuda, 2, True, 32, 192, 32, 24, 24)
    for name in FMT.PHASES:
        args, kw, _ = calls[name][0]
        a = getattr(FMT, name)(*args, **kw)
        b = getattr(FMT, name)(*args, **kw)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        for u, v in zip(a, b):
            assert torch.equal(u, v), name
    for block in ((160, 960, 320, 4, False), (96, 576, 160, 2, False)):
        calls = _train_block_calls(cuda, block[3], block[4], *block[:3],
                                   37, 21)
        for name in ("f1", "f3", "b2"):
            args, kw, _ = calls[name][0]
            a = getattr(FMT, name)(*args, **kw)
            b = getattr(FMT, name)(*args, **kw)
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            for u, v in zip(a, b):
                assert torch.equal(u, v), (name, block)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(None, None), (37, 21), (26, 7)])
@pytest.mark.parametrize("block", TRAIN_BLOCKS)
def test_b2_at_every_block_shape(cuda, block, H, W):
    """B2 at each block shape of the net, B=2, on its own map and two
    ragged ones (pixel groups cut short, Ce chunks cut short): T1, T2, dW2
    and ddh held to the plain version (2 bf16 ulps of bf16 outputs, 1e-3
    of f32 ones, FLIP_* for masks)."""
    Cin, Ce, Cout, rate, skip, side = block
    H, W = (side, side) if H is None else (H, W)
    calls = _train_block_calls(cuda, rate, skip, Cin, Ce, Cout, H, W)
    args, kw, want = calls["b2"][0]
    before = FMT.b2.launches
    got = FMT.b2(*args, **kw)
    torch.cuda.synchronize()
    assert FMT.b2.launches == before + 1
    err, rel, ok = FMT.max_err_vs_plain(got, want)
    assert ok, (err, rel)


@pytest.mark.gpu
def test_train_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(2, 8, 8, 16, device=cuda)              # f32: no kernel
    w1 = torch.zeros(16, 96, device=cuda, dtype=torch.bfloat16)
    before = FMT.f1.launches
    with pytest.raises(ValueError):
        FMT.f1(x, w1)
    with pytest.raises(ValueError):                         # Cin not x8
        FMT.f1(torch.zeros(2, 8, 8, 12, device=cuda, dtype=torch.bfloat16),
               torch.zeros(12, 96, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):                         # non-contiguous
        FMT.f1(x.to(torch.bfloat16).transpose(1, 2), w1)
    assert FMT.f1.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,rate", [
    (2, 37, 53, 24, 4),      # ragged map, C not a multiple of the chunk
    (1, 64, 64, 384, 2),     # 12 chunks of 32 channels
    (2, 20, 36, 7, 1),       # odd C: one channel a thread
    (1, 32, 32, 16, 18),     # the halo passes the map
])
def test_fused_dw_kernel_matches_reference(cuda, relu, x_dtype, B, H, W, C,
                                           rate):
    r = np.random.RandomState(C + rate)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (r.randn(*s) * sc).astype(np.float32)).to(cuda)
    x = t(B, H, W, C).to(x_dtype)
    k, scale, shift = t(3, 3, C, 1, sc=0.3), 1 + t(C, sc=0.2), t(C, sc=0.5)
    before = FDW.fused_dw_bn_relu6.launches
    got = FDW.fused_dw_bn_relu6(x, k, scale, shift, rate=rate, relu6=relu)
    ref = FDW.fused_dw_bn_relu6_reference(x, k, scale, shift, rate=rate,
                                          relu6=relu)
    torch.cuda.synchronize()
    assert FDW.fused_dw_bn_relu6.launches == before + 1
    assert got.dtype == x_dtype and got.shape == x.shape
    err = (got.float() - ref.float()).abs().max().item()
    scale_ = ref.float().abs().max().item()
    tol = 1e-5 if x_dtype == torch.float32 else 2 * 2.0 ** -8
    assert scale_ > 0 and err <= tol * scale_, (err, scale_)


@pytest.mark.gpu
@pytest.mark.parametrize("sw", FDW.DW_STRIPS)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,rate", [
    (8, 256, 256, 32, 1),    # block 0 of a B=8 512x512 request
    (8, 192, 192, 32, 1),    # at 384x384, a test-time augmentation twin
    (8, 320, 320, 32, 1),    # at 640x640
    (8, 188, 250, 32, 1),    # at VOC's 375x500
    (2, 64, 64, 384, 2),     # the JAX kernel's documented shape
    (2, 20, 36, 7, 1),       # C not a multiple of 4
    (2, 37, 53, 24, 4),      # ragged map
])
def test_fused_dw_bit_for_bit_at_each_strip(cuda, monkeypatch, sw, x_dtype,
                                            B, H, W, C, rate):
    monkeypatch.setattr(FDW, "DW_STRIPS", (sw,))
    FDW.dw_plan.cache_clear()
    try:
        assert FDW.dw_plan(B, H, W, C, rate, x_dtype).sw == sw
        r = np.random.RandomState(H + C + rate)
        t = lambda *s, sc=1.0: torch.from_numpy(
            (r.randn(*s) * sc).astype(np.float32)).to(cuda)
        x = t(B, H, W, C).to(x_dtype)
        k, scale, shift = t(3, 3, C, 1, sc=0.3), 1 + t(C, sc=0.2), t(C, sc=0.5)
        got = FDW.fused_dw_bn_relu6(x, k, scale, shift, rate=rate)
        ref = FDW.fused_dw_bn_relu6_reference(x, k, scale, shift, rate=rate)
        torch.cuda.synchronize()
        assert got.dtype == x_dtype and torch.equal(got, ref)
    finally:
        FDW.dw_plan.cache_clear()


@pytest.mark.gpu
def test_fused_dw_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.zeros(1, 8, 8, 16, device=cuda)
    k = torch.zeros(3, 3, 16, 1, device=cuda)
    s = torch.ones(16, device=cuda)
    before = FDW.fused_dw_bn_relu6.launches
    with pytest.raises(ValueError):                 # no fp16 mode
        FDW.fused_dw_bn_relu6(x.half(), k, s, s)
    with pytest.raises(ValueError):                 # non-contiguous input
        FDW.fused_dw_bn_relu6(x.transpose(1, 2), k, s, s)
    with pytest.raises(ValueError):                 # bf16 taps
        FDW.fused_dw_bn_relu6(x, k.bfloat16(), s, s)
    assert FDW.fused_dw_bn_relu6.launches == before


def _scene_on(cuda, H, W, L, seed):
    im, mask = make_scene(H, W, L, seed)
    U = CRF.dense_crf.unary_from_labels(torch.from_numpy(mask).reshape(-1),
                                        L, 0.7, zero_unsure=False)
    U = U + torch.from_numpy(np.random.RandomState(seed).rand(*U.shape)
                             .astype(np.float32)) * 0.5
    return torch.from_numpy(im).to(cuda), U.to(cuda)


def _counts():
    return {n: getattr(CK, n).launches
            for n in CK.KERNELS + ("slice_planes",)}


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,H,W,L", [
    (CRF.CrfConfig(backend="xla"), 96, 200, 21),          # nc 21, padded
    # nc 15, nnls taps, stride 2
    (dataclasses.replace(CRF.PRODUCTION_CONFIG, backend="xla"), 80, 120, 11),
    (CRF.CrfConfig(sxy_bilateral=15.0, backend="xla"), 30, 30, 5),  # P = 225
])
def test_xla_engine_kernels_match_reference(cuda, cfg, H, W, L):
    im, U = _scene_on(cuda, H, W, L, 3)
    with CK.plain_versions(CK.XLA_KERNELS) as calls:
        q_plain = CRF.mean_field(im, U, cfg, L)
    assert {n: len(c) for n, c in calls.items()} == {
        "splat_planes": 6, "slice_planes": 6}
    for kname in CK.XLA_KERNELS:
        kernel = getattr(CK, kname)
        for args, kw, want in calls[kname]:
            before = kernel.launches
            got = kernel(*args, **kw)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            err, ok = CK.max_err_vs_plain(kname, got, want)
            assert ok, (kname, err)
    before = _counts()
    q = CRF.mean_field(im, U, cfg, L)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in _counts().items()}
    assert moved == {"splat_planes": 6, "slice_attrs_planes": 0,
                     "gaussian_blur_planes": 0, "mf_step_planes": 0,
                     "slice_planes": 6}, moved
    agree = (q.argmax(-1) == q_plain.argmax(-1)).float().mean().item()
    assert agree >= 0.99, agree


@pytest.mark.gpu
@pytest.mark.parametrize("name,H,W,L", [("FAITHFUL_CONFIG", 128, 256, 21),
                                        ("PRODUCTION_CONFIG", 80, 120, 11)])
def test_explicit_unary_step_matches_reference(cuda, name, H, W, L):
    cfg = getattr(CRF, name)
    im, U = _scene_on(cuda, H, W, L, 4)
    with CK.plain_versions() as calls:
        q_plain = CRF.mean_field(im, U, cfg, L)
    assert len(calls["mf_step_planes"]) == cfg.n_iters
    for args, kw, want in calls["mf_step_planes"]:
        assert args[4] is not None and args[4].dtype == torch.bfloat16
        before = CK.mf_step_planes.launches
        got = CK.mf_step_planes(*args, **kw)
        torch.cuda.synchronize()
        assert CK.mf_step_planes.launches == before + 1
        err, ok = CK.max_err_vs_plain("mf_step_planes", got, want)
        assert ok, err
    before = _counts()
    q = CRF.mean_field(im, U, cfg, L)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in _counts().items()}
    assert moved == {"splat_planes": 6, "slice_attrs_planes": 1,
                     "gaussian_blur_planes": 5, "mf_step_planes": 5,
                     "slice_planes": 0}, moved
    agree = (q.argmax(-1) == q_plain.argmax(-1)).float().mean().item()
    assert agree >= 0.99, agree


# ---------------------------------------------------------------------------
# The redesigned splat and mean-field step (sorted pieces; the fused and the
# two-kernel step).

def _splat_cells(kind, Z, P, seed):
    """(Z, 8, P) packed attrs planes of one color, of uniform noise, or of
    the committed CRF scenes (their first 32x64 pixels per cell)."""
    rs = np.random.RandomState(seed)
    if kind == "flat":
        rgb = np.full((Z, 3, P), 131.0, np.float32)
    elif kind == "noise":
        rgb = rs.uniform(0, 255, (Z, 3, P)).astype(np.float32)
    else:
        rgb = np.stack([make_scene(64, 128, 5, seed + z)[0][:32, :64]
                        .reshape(P, 3).T for z in range(Z)])
    attrs = np.zeros((Z, CK.ATTR_ROWS, P), np.float32)
    attrs[:, :3] = rgb
    attrs[:, CK.ATTR_BSCALE] = rs.uniform(0.5, 4.0, (Z, P))
    return attrs


@pytest.mark.gpu
@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("nc", [9, 13, 15, 21])
@pytest.mark.parametrize("L", [1, 2, 5, 21])
@pytest.mark.parametrize("kind", ["flat", "noise", "structured"])
def test_splat_on_flat_noise_and_structured_cells(cuda, kind, L, nc,
                                                  values):
    """f32 values with rgb planes (the norm pass) or bf16 values with packed
    attrs planes (the iterations), on 3 cells of 2048 pixels."""
    Z, P = 3, 2048
    inv_step = (nc - 1.5) / 255.0
    attrs = _splat_cells(kind, Z, P, 7)
    rs = np.random.RandomState(8)
    if values == "f32":
        rgb = torch.from_numpy(np.ascontiguousarray(attrs[:, :3])).to(cuda)
        v = torch.from_numpy(rs.rand(Z, L, P).astype(np.float32)).to(cuda)
        dt = torch.float32
    else:
        rgb = torch.from_numpy(attrs).to(cuda)
        v = torch.from_numpy(rs.rand(Z, L, P).astype(np.float32)).to(
            cuda, torch.bfloat16)
        dt = torch.bfloat16
    kw = dict(nc=nc, L=L, inv_step=inv_step, out_dtype=dt)
    before = CK.splat_planes.launches
    got = CK.splat_planes(rgb, v, **kw)
    want = CK.splat_planes_reference(rgb, v, **kw)
    torch.cuda.synchronize()
    assert CK.splat_planes.launches == before + 1
    err, ok = CK.max_err_vs_plain("splat_planes", got, want)
    assert ok, (kind, L, nc, values, err)


def _step_calls(cuda, cfg, H, W, L, unary):
    """The step's calls of a CRF run with the plain versions: (args, kw,
    out), through mean_field_batched or, with the explicit unary, through
    mean_field."""
    scenes = [make_scene(H, W, L, seed) for seed in (1, 2)]
    with CK.plain_versions() as calls:
        if unary:
            im, mask = scenes[0]
            U = CRF.dense_crf.unary_from_labels(
                torch.from_numpy(mask).reshape(-1), L, 0.7,
                zero_unsure=False)
            CRF.mean_field(torch.from_numpy(im).to(cuda), U.to(cuda), cfg, L)
        else:
            imgs = torch.from_numpy(np.stack([s[0] for s in scenes]))
            masks = torch.from_numpy(np.stack([s[1] for s in scenes]))
            CRF.mean_field_batched(imgs.to(cuda), masks.to(cuda), cfg, L)
    return calls["mf_step_planes"]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,H,W,L,unary,fused", [
    # nc 15, stride 2 (4 calls with the subsampled copy, the last without):
    # the 21-label instantiation, then the run-time label count
    (CRF.PRODUCTION_CONFIG, 128, 256, 21, False, True),
    (CRF.PRODUCTION_CONFIG, 128, 256, 11, False, True),
    # nc 21: 5 labels fuse, 21 labels (a 389 KB grid) take two kernels
    (CRF.FAITHFUL_CONFIG, 64, 256, 5, False, True),
    (CRF.FAITHFUL_CONFIG, 64, 256, 21, False, False),
    # the explicit-unary form, one image (Z < the SMs: several blocks a cell)
    (CRF.PRODUCTION_CONFIG, 80, 120, 11, True, True),
    (CRF.CrfConfig(), 128, 256, 21, True, False),
    (CRF.CrfConfig(), 128, 256, 5, True, True),
    # 40 labels: past the registers' 32, two kernels, logits in shared memory
    (CRF.THROUGHPUT_CONFIG, 64, 128, 40, False, False),
])
def test_step_forms_match_reference_and_each_other(cuda, cfg, H, W, L,
                                                   unary, fused):
    calls = _step_calls(cuda, cfg, H, W, L, unary)
    assert len(calls) == cfg.n_iters
    strides = set()
    for args, kw, want in calls:
        assert (args[4] is not None) == unary
        Z, _, P = args[0].shape
        plan = CK.step_plan(Z, P, kw["nc"], L)
        assert plan.fused == fused
        strides.add(kw["sub_stride"])
        before = CK.mf_step_planes.launches
        got = CK.mf_step_planes(*args, **kw)
        two = CK.mf_step_with_plan(
            CK.two_kernel_step_plan(kw["nc"], L), *args, **kw)
        torch.cuda.synchronize()
        assert CK.mf_step_planes.launches == before + 2
        for out in (got, two):
            err, ok = CK.max_err_vs_plain("mf_step_planes", out, want)
            assert ok, (L, unary, err)
        # one summation order in both forms: equal bit for bit
        assert all(torch.equal(a, b) for a, b in zip(got, two))
    assert strides == {1, cfg.splat_stride}


@pytest.mark.gpu
def test_splat_and_step_raise_instead_of_falling_back(cuda, monkeypatch):
    """A launch the library reports as failed, or a plan its launcher does
    not reproduce, raises; the count of launches does not move and no plain
    version runs in the kernel's place."""
    attrs = torch.from_numpy(_splat_cells("noise", 2, 256, 3)).to(cuda)
    v = torch.rand(2, 3, 256, device=cuda).to(torch.bfloat16)
    kw = dict(nc=15, L=3, inv_step=1 / 19.5, out_dtype=torch.bfloat16)
    real = CK.splat_plan(2, 256, 3, 15)
    bad = dataclasses.replace(real, smem=real.smem + 16)
    monkeypatch.setattr(CK, "splat_plan", lambda *a: bad)
    before = CK.splat_planes.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        CK.splat_planes(attrs, v, **kw)
    assert CK.splat_planes.launches == before
    monkeypatch.undo()

    calls = _step_calls(cuda, CRF.PRODUCTION_CONFIG, 64, 128, 5, False)
    args, skw, _ = calls[0]
    Z, _, P = args[0].shape
    plan = CK.step_plan(Z, P, skw["nc"], 5)
    before = CK.mf_step_planes.launches
    for wrong in (dataclasses.replace(plan, smem=plan.smem + 16),
                  dataclasses.replace(CK.two_kernel_step_plan(skw["nc"], 5),
                                      lp=8 + 4)):
        with pytest.raises(RuntimeError, match="launch failed"):
            CK.mf_step_with_plan(wrong, *args, **skw)
    assert CK.mf_step_planes.launches == before

    class FailedLaunch:               # the library reports a launch error
        @staticmethod
        def crf_mf_step_launch(*a):
            return 9                  # cudaErrorInvalidConfiguration

        @staticmethod
        def crf_splat_launch(*a):
            return 9

        @staticmethod
        def crf_error(code):
            return b"invalid configuration argument"
    monkeypatch.setattr(CK, "_lib", lambda: FailedLaunch)
    with pytest.raises(RuntimeError, match="launch failed"):
        CK.mf_step_planes(*args, **skw)
    with pytest.raises(RuntimeError, match="launch failed"):
        CK.splat_planes(attrs, v, **kw)
    assert CK.mf_step_planes.launches == before
