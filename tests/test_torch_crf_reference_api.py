"""The reference-API CRF of the port against the JAX package, on the CPU:
``slice_planes`` and the explicit-unary mean-field step (plain versions
against the Pallas kernels in interpret mode), the XLA engine's
``bilateral_filter``, ``mean_field`` on both engines, ``do_crf`` and
``mean_field_batched(backend="xla")``.

Tolerances, each with its reason:

- ``slice_planes`` and the step: both sides take the same bf16-rounded
  operands and differ in the order of f32 sums, so one bf16 rounding of the
  blurred grid (or of Q) can flip: 2 bf16 ulps of the largest value.
- ``bilateral_filter``: against an exact float64 filter of the same cells,
  hat factors and bands, 1e-2 of the largest value (the port's bf16
  roundings of the splat operands, the grid, the color-blur weights and the
  blurred grid; measured at most 5.8e-3).  Against JAX 2e-2: the JAX XLA
  engine rounds elsewhere (the blurred grid, its bf16 slice and the b
  weights; measured up to 9.3e-3 from exact), so the two may differ by the
  sum (measured up to 1.07e-2).
- ``mean_field``, ``do_crf`` and ``mean_field_batched``: argmax agreement
  >= 0.99 (the engines differ from JAX only by bf16 rounding); ``do_crf``
  against the exact O(N^2) oracle (``deeplab_tpu.crf.brute``) > 0.97, the
  floor of tests/test_crf.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crf_scenes import make_scene
from deeplab_tpu import crf as JCRF
from deeplab_tpu.crf import dense_crf as JDC
from deeplab_tpu.crf.brute import exact_crf_map
from deeplab_tpu.kernels import crf_fused as JK

from deeplab_tpu_torch import crf as TCRF
from deeplab_tpu_torch.crf import dense_crf as TDC
from deeplab_tpu_torch.kernels import crf_fused as TK

BF16_REL = 2 * 2.0 ** -8


def _close(got, want, rel, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    print(f"{what}: max_abs {err:.3e} of max {scale:.3e}")
    assert scale > 0 and err <= rel * scale, (what, err, scale)


def _jax_grid(grid, nc, L, ctaps):
    """The port's (Z, nc*L, nc^2) grid and color taps as the JAX kernels
    take them: zero-padded to the TPU's tiles, and the dense joint (r, g)
    blur matrix."""
    g = grid.float().numpy()
    C, D = nc * nc, nc * L
    gp = np.zeros((g.shape[0], JK._d_pad(nc, L), JK._c_pad(nc)), np.float32)
    gp[:, :D, :C] = g
    band = TK.band_matrix_np(nc, np.asarray(ctaps, np.float32))
    brg = np.zeros((JK._c_pad(nc),) * 2, np.float32)
    brg[:C, :C] = np.kron(band, band)
    return gp, brg


@pytest.mark.parametrize("Z,P,nc,L,inv,ctaps", [
    # the fixture of tests/test_pallas_kernels.py
    (3, 256, 5, 4, 1.0 / 64.0, (0.25, 1.0, 0.25)),
    # the production color grid (nc 15, nnls taps) at 21 labels, 2 cells
    (2, 512, 15, 21, 1.0 / 19.5,
     tuple(float(t) for t in TDC._cfg_color_taps(TCRF.PRODUCTION_CONFIG))),
])
def test_slice_planes_matches_jax(Z, P, nc, L, inv, ctaps):
    rng = np.random.RandomState(2)
    rgb = rng.rand(Z, 3, P).astype(np.float32) * 255
    grid = torch.from_numpy(rng.rand(Z, nc * L, nc * nc).astype(np.float32))
    got = TK.slice_planes_reference(torch.from_numpy(rgb), grid, nc=nc, L=L,
                                    inv_step=inv, ctaps=ctaps)
    gp, brg = _jax_grid(grid, nc, L, ctaps)
    want = JK.slice_planes(jnp.asarray(rgb), jnp.asarray(gp),
                           jnp.asarray(brg), nc=nc, L=L, inv_step=inv,
                           bb_taps=ctaps, interpret=True)
    assert got.dtype == torch.float32
    _close(got, want, BF16_REL, "slice_planes")
    assert TK.slice_planes.launches == 0


@pytest.mark.parametrize("sub_stride", [1, 2])
def test_explicit_unary_step_matches_jax(sub_stride):
    """The step with the caller's energies (the unary stream) on 2 cells of
    8x128 with the production color grid."""
    Z, cs_y, cs_x, nc, L = 2, 8, 128, 15, 6
    P, inv = cs_y * cs_x, 1.0 / 19.5
    ctaps = tuple(float(t) for t in TDC._cfg_color_taps(
        TCRF.PRODUCTION_CONFIG))
    rng = np.random.RandomState(3)
    rgb = rng.rand(Z, 3, P).astype(np.float32) * 255
    gn, bn, bs = (rng.rand(Z, 1, P).astype(np.float32) for _ in range(3))
    zeros = np.zeros((Z, 1, P), np.float32)
    attrs = np.concatenate([rgb, gn, bn, bs, zeros, zeros], axis=1)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    grid = bf(rng.rand(Z, nc * L, nc * nc))
    fg, q = bf(rng.rand(Z, L, P)), bf(rng.dirichlet(np.ones(L), (Z, P))
                                      .transpose(0, 2, 1))
    unary = bf(rng.rand(Z, L, P) * 3)
    kw = dict(cg=3.0, cb=10.0, sub_stride=sub_stride, cs_y=cs_y, cs_x=cs_x)
    got = TK.mf_step_planes_reference(torch.from_numpy(attrs), grid, fg, q,
                                      unary, nc=nc, L=L, inv_step=inv,
                                      ctaps=ctaps, **kw)
    gp, brg = _jax_grid(grid, nc, L, ctaps)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = JK.mf_step_planes(
        jnp.asarray(attrs), jnp.asarray(gp).astype(jnp.bfloat16),
        jnp.asarray(brg), j(fg), j(q), j(unary), nc=nc, L=L, inv_step=inv,
        bb_taps=ctaps, chunk=P, interpret=True, **kw)
    assert len(got) == len(want) == (2 if sub_stride > 1 else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        _close(g, w, BF16_REL, f"unary step[{i}]")
    # the explicit two-level unary equals the one rebuilt from the label row
    lab = rng.randint(0, L, (Z, 1, P))
    attrs_l = attrs.copy()
    attrs_l[:, TK.ATTR_LABEL:TK.ATTR_LABEL + 1] = lab
    n_e, p_e = 1.5, 0.25
    u2 = torch.from_numpy(np.where(lab == np.arange(L)[None, :, None], p_e,
                                   n_e).astype(np.float32))
    kw1 = dict(kw, sub_stride=1)
    by_label = TK.mf_step_planes_reference(
        torch.from_numpy(attrs_l), grid, fg, q, nc=nc, L=L, inv_step=inv,
        ctaps=ctaps, n_energy=n_e, p_energy=p_e, **kw1)
    by_stream = TK.mf_step_planes_reference(
        torch.from_numpy(attrs), grid, fg, q, u2.to(torch.bfloat16), nc=nc,
        L=L, inv_step=inv, ctaps=ctaps, **kw1)
    torch.testing.assert_close(by_label[0], by_stream[0], rtol=0, atol=0)


def _exact_bilateral(im, vals, sxy, srgb, stride):
    """The XLA engine's bilateral filter in float64 without any rounding:
    square cells, hat factors, the splat of every stride-th pixel (x
    stride^2), the cross-cell band at step 1 and the three color bands."""
    H, W, _ = im.shape
    L = vals.shape[1]
    cs = int(round(sxy))
    ny, nx, Z = -(-H // cs), -(-W // cs), -(-H // cs) * -(-W // cs)
    nc = int(np.floor(255.0 / srgb)) + 2
    taps = TDC._blur_taps(1.0).astype(np.float64)

    def cells(x):
        pad = np.zeros((ny * cs, nx * cs, x.shape[-1]))
        pad[:H, :W] = x
        return pad.reshape(ny, cs, nx, cs, -1).transpose(0, 2, 1, 3, 4) \
            .reshape(Z, cs, cs, -1)
    co, vc = cells(im.astype(np.float64) / srgb), cells(
        vals.reshape(H, W, L).astype(np.float64))
    ar, ag, ab = (np.maximum(1 - np.abs(np.arange(nc) - co[..., i, None]), 0)
                  for i in range(3))
    G = np.zeros((Z, nc, nc, nc, L))
    sub = (slice(None, None, stride),) * 2
    for z in range(Z):
        trg = (ar[z][sub][..., :, None] * ag[z][sub][..., None, :])
        tlb = (ab[z][sub][..., :, None] * vc[z][sub][..., None, :])
        G[z] = (trg.reshape(-1, nc * nc).T @ tlb.reshape(-1, nc * L)
                ).reshape(nc, nc, nc, L) * stride * stride
    S = np.kron(TK.band_matrix_np(ny, taps), TK.band_matrix_np(nx, taps))
    band = TK.band_matrix_np(nc, taps).astype(np.float64)
    G = np.einsum("zy,zrgbl->yrgbl", S, G, optimize=True)
    for eq in ("rR,zrgbl->zRgbl", "gG,zrgbl->zrGbl", "bB,zrgbl->zrgBl"):
        G = np.einsum(eq, band, G, optimize=True)
    out = np.zeros((Z, cs * cs, L))
    for z in range(Z):                    # the slice, one cell at a time
        trg = (ar[z][..., :, None] * ag[z][..., None, :]).reshape(-1, nc * nc)
        m = (trg @ G[z].reshape(nc * nc, nc * L)).reshape(-1, nc, L)
        out[z] = (m * ab[z].reshape(-1, nc, 1)).sum(1)
    return (out.reshape(ny, nx, cs, cs, L).transpose(0, 2, 1, 3, 4)
            .reshape(ny * cs, nx * cs, L)[:H, :W].reshape(-1, L))


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("hw", [(96, 96), (128, 256)])
@pytest.mark.parametrize("stride", [1, 2])
def test_bilateral_filter_matches_jax(hw, L, stride):
    H, W = hw
    im, _ = make_scene(H, W, 5, 3)
    vals = np.random.RandomState(L).rand(H * W, L).astype(np.float32)
    exact = _exact_bilateral(im, vals, 80.0, 13.0, stride)
    if stride == 1:
        got = TDC.bilateral_filter(torch.from_numpy(im),
                                   torch.from_numpy(vals), 80.0, 13.0)
        want = JDC.bilateral_filter(jnp.asarray(im), jnp.asarray(vals),
                                    80.0, 13.0)
    else:
        got = TDC.BilateralPlan(torch.from_numpy(im), 80.0, 13.0, 1.0,
                                stride).apply(torch.from_numpy(vals))
        want = JDC._BilateralPlan(jnp.asarray(im), 80.0, 13.0, 1.0,
                                  stride).apply(jnp.asarray(vals))
    what = f"bilateral_filter {hw} L={L} stride={stride}"
    _close(got, exact, 1e-2, what + " vs exact")
    _close(got, want, 2e-2, what + " vs JAX")


def test_bilateral_norm_and_message_match_jax():
    im, _ = make_scene(96, 96, 5, 4)
    q = np.random.RandomState(5).dirichlet(np.ones(3), 96 * 96).astype(
        np.float32)
    ti, ji = torch.from_numpy(im), jnp.asarray(im)
    np.testing.assert_allclose(
        TDC.bilateral_self_weight(ti, 80.0, 13.0).numpy(),
        np.asarray(JDC.bilateral_self_weight(ji, 80.0, 13.0)), rtol=1e-6)
    norm, w_self = TDC.bilateral_norm(ti, 80.0, 13.0)
    jnorm, jw = JDC.bilateral_norm(ji, 80.0, 13.0)
    _close(norm, jnorm, 2e-2, "bilateral_norm")
    np.testing.assert_array_equal(w_self.numpy(), np.asarray(jw))
    _close(TDC.bilateral_message(ti, torch.from_numpy(q), 80.0, 13.0),
           JDC.bilateral_message(ji, jnp.asarray(q), 80.0, 13.0), 2e-2,
           "bilateral_message")


def test_gaussian_message_matches_jax():
    q = np.random.RandomState(6).rand(37, 61, 4).astype(np.float32)
    np.testing.assert_allclose(
        TDC.gaussian_message(torch.from_numpy(q), 3.0).numpy(),
        np.asarray(JDC.gaussian_message(jnp.asarray(q), 3.0)),
        rtol=1e-4, atol=1e-5)


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_mean_field_matches_jax(engine):
    """Caller energies (the two-level unary plus seeded noise, so the unary
    stream carries more than two values) on a 128x256 scene at sxy 80."""
    im, mask = make_scene(128, 256, 5, 13)
    U = np.asarray(JDC.unary_from_labels(jnp.asarray(mask), 5, 0.7, False))
    U = (U + np.random.RandomState(7).rand(*U.shape) * 0.5).astype(
        np.float32)
    want = np.asarray(JDC.mean_field(jnp.asarray(im), jnp.asarray(U),
                                     JCRF.CrfConfig(backend=engine), 5))
    got = TCRF.mean_field(torch.from_numpy(im), torch.from_numpy(U),
                          TCRF.CrfConfig(backend=engine), 5)
    assert got.dtype == torch.float32 and got.shape == (128 * 256, 5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-2)
    agree = _agree(got.argmax(-1).numpy(), want.argmax(-1))
    moved = _agree(want.argmax(-1), U.argmin(-1))
    print(f"{engine}: argmax agreement with JAX {agree:.5f}, Q max_abs "
          f"{np.abs(got.numpy() - want).max():.3e}; JAX kept {moved:.4f} "
          f"of the unary's argmin")
    assert moved < 0.99                   # the CRF did something
    assert agree >= 0.99, agree


def _toy_scene(h=24, w=24, seed=0):
    """Two color regions with a noisy label mask across the boundary (the
    scene of tests/test_crf.py)."""
    rng = np.random.RandomState(seed)
    im = np.zeros((h, w, 3), np.float32)
    im[:, :w // 2] = [200, 40, 40]
    im[:, w // 2:] = [40, 40, 200]
    im = np.clip(im + rng.randn(h, w, 3) * 8, 0, 255)
    mask = np.zeros((h, w), np.int32)
    mask[:, w // 2:] = 1
    noise = rng.rand(h, w) < 0.15
    mask[noise] = 1 - mask[noise]
    return im, mask


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("case", ["labels", "remap", "zero_unsure"])
def test_do_crf_matches_jax_and_oracle(engine, case):
    im, mask = _toy_scene(seed=1)
    zu = case == "zero_unsure"
    if case == "remap":                   # sparse ids come back as they were
        mask = np.where(mask == 1, 15, 7)
    elif zu:                              # label 0 is "unsure"
        mask = mask + 1
        mask[5:8, 5:8] = 0
    got = TCRF.do_crf(im, mask, zero_unsure=zu,
                      cfg=TCRF.CrfConfig(backend=engine), device="cpu")
    want = JCRF.do_crf(im, mask, zero_unsure=zu,
                       cfg=JCRF.CrfConfig(backend=engine))
    oracle = exact_crf_map(im, mask, zero_unsure=zu)
    assert got.shape == mask.shape and got.dtype == mask.dtype
    assert set(np.unique(got)) <= set(np.unique(mask)) | {0}
    print(f"{engine} {case}: JAX {_agree(got, want):.4f}, oracle "
          f"{_agree(got, oracle):.4f}")
    assert _agree(got, want) >= 0.99
    assert _agree(got, oracle) > 0.97
    if case == "remap":
        assert set(np.unique(got)) <= {7, 15}


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_do_crf_single_label_is_a_no_op(engine):
    im, _ = _toy_scene()
    mask = np.full(im.shape[:2], 4, np.int32)
    out = TCRF.do_crf(im, mask, zero_unsure=False,
                      cfg=TCRF.CrfConfig(backend=engine), device="cpu")
    np.testing.assert_array_equal(out, mask)
    assert out is not mask


@pytest.mark.parametrize("name", ["FAITHFUL_CONFIG", "PRODUCTION_CONFIG"])
def test_mean_field_batched_xla_matches_jax(name):
    """The XLA engine image by image (nc 21 gaussian taps; nc 15 nnls taps
    with a 2x subsampled splat and the b_self floor) on padded 64x96
    scenes."""
    ims, ms = zip(*[make_scene(64, 96, 11, s) for s in (7, 8)])
    im, mask = np.stack(ims), np.stack(ms)
    jcfg = dataclasses.replace(getattr(JCRF, name), backend="xla")
    tcfg = dataclasses.replace(getattr(TCRF, name), backend="xla")
    want = np.asarray(JDC.mean_field_batched(jnp.asarray(im),
                                             jnp.asarray(mask), jcfg, 11))
    got = TCRF.mean_field_batched(torch.from_numpy(im),
                                  torch.from_numpy(mask), tcfg, 11)
    assert got.dtype == torch.int32 and got.shape == mask.shape
    agree = _agree(got.numpy(), want)
    print(f"{name} xla: mask agreement with JAX {agree:.5f}, the CRF "
          f"changed {1 - _agree(want, mask):.4f} of the pixels")
    assert 1 - _agree(want, mask) > 0.01
    assert agree >= 0.99, agree


def test_xla_engine_records_its_two_kernels():
    """6 splats and 6 slices per mean_field (the norm pass and 5
    iterations), recorded by the recorder chip_smoke.py holds the kernels
    to their plain versions with."""
    im, mask = make_scene(40, 56, 4, 2)
    U = TDC.unary_from_labels(torch.from_numpy(mask).reshape(-1), 4, 0.7,
                              False)
    cfg = TCRF.CrfConfig(backend="xla", sxy_bilateral=16.0)
    with TK.plain_versions(TK.XLA_KERNELS) as calls:
        q = TCRF.mean_field(torch.from_numpy(im), U, cfg, 4)
    assert {n: len(c) for n, c in calls.items()} == {
        "splat_planes": 6, "slice_planes": 6}
    for args, kw, out in calls["slice_planes"]:
        assert TK.max_err_vs_plain("slice_planes", out, out) == (0.0, True)
    torch.testing.assert_close(q, TCRF.mean_field(torch.from_numpy(im), U,
                                                  cfg, 4), rtol=0, atol=0)
