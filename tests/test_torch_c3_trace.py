"""C3's tracing (``fused_mbconv_train.unexplained``), the rule that both
chip_smoke.py's training-kernel check and tests/test_torch_kernels_gpu.py
apply to the halo phases F2 and B34, on the CPU: the plain versions of a
training block's phases stand in for the kernels, with outputs perturbed
the ways the rule must tell apart.

- Outputs equal to the plain version's: nothing over tolerance, nothing to
  trace.
- An output with one eq rounded the other way at its bf16 boundary (what
  the tensor cores' sums do, PERF.md C3): every element it moves past
  tolerance is traced to that eq.
- One element moved past tolerance with no eq to explain it, or past
  ``FLIP_REL``: unexplained.
"""

import numpy as np
import pytest
import torch

from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT


@pytest.fixture(scope="module")
def calls():
    torch.manual_seed(0)
    r = np.random.RandomState(5)
    t = lambda *s, sc=1.0: torch.from_numpy((r.randn(*s) * sc).astype(
        np.float32))
    B, H, W, Cin, Ce, Cout = 2, 8, 8, 16, 48, 16
    x = t(B, H, W, Cin).to(torch.bfloat16).requires_grad_()
    w = [t(Cin, Ce, sc=0.3), 1 + t(Ce, sc=0.1), t(Ce, sc=0.1),
         t(9, Ce, sc=0.3), 1 + t(Ce, sc=0.1), t(Ce, sc=0.1),
         t(Ce, Cout, sc=0.2), 1 + t(Cout, sc=0.1), t(Cout, sc=0.1)]
    w = [v.requires_grad_() for v in w]
    with FMT.plain_versions() as rec:
        out, _ = FMT.block_train(x, *w, rate=1, skip=True)
        (out.float() * t(B, H, W, Cout)).sum().backward()
    return rec


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.mark.parametrize("name", ["f2", "b34"])
def test_equal_outputs_need_no_trace(calls, name):
    args, kw, want = calls[name][0]
    assert FMT.unexplained(name, args, kw, want, want) == ([], 0)


def test_an_eq_flip_is_traced():
    """F2 on a map with one nonzero pixel, so that each channel's sums
    come from that pixel's eq alone, and one channel's expand exactly
    halfway between two bf16 values (1 + 2^-8): rounded the other way, its
    eq moves the channel's sums past tolerance (one bf16 ulp of eq is
    2^-7 of it, the f32 sums' tolerance 1e-3; the channel's taps are
    scaled to lead the sums).  The rule traces each such element to that
    eq and leaves none unexplained."""
    r = np.random.RandomState(7)
    B, H, W, Cin, Ce, c = 1, 8, 8, 16, 64, 21
    x = torch.zeros(B, H, W, Cin, dtype=torch.bfloat16)
    x[0, 3, 4, 0] = 1.0
    w1 = torch.from_numpy((r.randn(Cin, Ce) * 0.5).astype(np.float32))
    w1[0, c] = 1.0 + 2.0 ** -8
    a1, c1 = torch.ones(Ce), torch.full((Ce,), -0.05)   # relu6(0 - .05) = 0
    wdw = torch.from_numpy((r.rand(9, Ce) * 0.3).astype(np.float32))
    wdw[:, c] *= 20.0
    args, kw = (x, w1, a1, c1, wdw), {"rate": 1}
    with torch.no_grad():
        want = FMT.f2_reference(*args, **kw)
    got = FMT._flipped("f2", args, kw, (0, 3, 4, c))
    ds = (got[0] - want[0]).abs()
    assert ds.max() > FMT.PLAIN_F32_REL * want[0].abs().max()
    logs = []
    bad, n = FMT.unexplained("f2", args, kw, got, want, log=logs.append)
    assert not bad, bad
    assert n == len(logs) >= 1
    assert all(f"eq at [0, 3, 4, {c}]" in m for m in logs), logs


@pytest.mark.parametrize("name", ["f2", "b34"])
def test_a_moved_element_is_unexplained(calls, name):
    args, kw, want = calls[name][0]
    want_t = _as_tuple(want)
    o = max(range(len(want_t)), key=lambda i: want_t[i].numel())
    w = want_t[o]
    scale = w.float().abs().max().item()
    for shift, what in ((0.02, None), (0.2, "over FLIP_REL")):
        g = w.float().clone()
        g.view(-1)[w.numel() // 3] += shift * scale
        got = tuple(g.to(w.dtype) if i == o else v
                    for i, v in enumerate(want_t))
        bad, _ = FMT.unexplained(name, args, kw, got, want)
        assert bad, shift
        if what:
            assert (name, o, what) in bad
