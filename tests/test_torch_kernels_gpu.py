"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and numpy, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Without CUDA every test skips (the kernels have no CPU mode).  Shapes are
small and ragged (maps that are not multiples of the kernel's 8x8 tile) to
reach the edge handling that the main path's 64x64 and 128x128 maps do not.

Tolerance: both sides take the same bf16 matmul operands and accumulate in
f32; a summation-order ulp can flip one bf16-rounded depthwise output
(2^-8 relative) and bf16 outputs round once more: 2e-2 at outputs of order 1.

The CRF kernels are held to their plain versions on the inputs the main path
gives them: a CRF run with the plain versions records every call, then each
kernel runs on the recorded inputs and is compared with the recorded output
(``crf_fused.plain_versions`` and ``max_err_vs_plain``, as chip_smoke.py
does; tolerances there: f32 outputs 1e-4 of the largest value, bf16 outputs
2 bf16 ulps, the step's Q 4 ulps).  The geometries: production (nc 15, stride 2), fast-faithful
(nc 13, stride 1), throughput (nc 9, stride 4) and faithful (nc 21, whose
blurred grid is too large for shared memory), with padded cells.
"""

import numpy as np
import pytest
import torch

from crf_scenes import make_scene
from deeplab_tpu_torch import crf as CRF
from deeplab_tpu_torch.kernels import crf_fused as CK
from deeplab_tpu_torch.kernels import fused_mbconv as FM


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


def _train_block_calls(dev, rate, skip, Cin, Ce, Cout, H, W, B=2, seed=5):
    """Run one training block forward and backward with the plain versions
    on ``dev``; returns the recorded {phase: [(args, kw, out)]}."""
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
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
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
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


@pytest.mark.gpu
def test_train_phase_sums_repeat_bit_for_bit(cuda):
    """Per-block partials and a fixed-order second pass: no atomics."""
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
    calls = _train_block_calls(cuda, 2, True, 32, 192, 32, 24, 24)
    for name in ("f1", "b2", "b34"):
        args, kw, _ = calls[name][0]
        a = getattr(FMT, name)(*args, **kw)
        b = getattr(FMT, name)(*args, **kw)
        for u, v in zip(a, b):
            assert torch.equal(u, v), name


@pytest.mark.gpu
def test_train_wrappers_raise_instead_of_falling_back(cuda):
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
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
