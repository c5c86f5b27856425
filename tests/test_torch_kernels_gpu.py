"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and numpy, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Without CUDA every test skips (the kernels have no CPU mode).  Shapes are
small and ragged (maps that are not multiples of the kernel's 8x8 tile) to
reach the edge handling that the main path's 64x64 and 128x128 maps do not.

Tolerance: both sides take the same bf16 matmul operands and accumulate in
f32; a summation-order ulp can flip one bf16-rounded depthwise output
(2^-8 relative) and bf16 outputs round once more: 2e-2 at outputs of order 1.
"""

import numpy as np
import pytest
import torch

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
