"""The dense CRF at the geometries and scales past the production path, the
port against the JAX package on the CPU: the spatial blur's y and x passes
(the TPU's fallback kernels ``_blur_y_kernel`` and ``_blur_x_kernel``), the
plane engine's image-layout blur for cells narrower than 128 px, and
``resolution_scale`` on both engines.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True``,
``backend="pallas"``); inputs are made with numpy from a seed.  To hold each
pass on its own, the JAX blur runs with ``jax.disable_jit`` and a recorder
around ``pallas_call`` that keeps each kernel's output.

Tolerances, each from the rounding the two sides share:

- the passes, the fallback and the image-layout blur: both take the same
  bf16 operands, whose products are exact in f32, and differ only in the
  order of f32 sums, so one bf16 rounding may flip: 2 bf16 ulps of the
  largest value (``PLAIN_BF16_REL``; measured 0 at r = 8, up to 0.6% of the
  largest value at r = 18 and 30, where the TPU's y product sums 37 or 61
  terms in another order);
- the y pass then the x pass against ``gaussian_blur_planes_reference``
  (the row kernel's plain version): bit for bit, the same function;
- masks of the plane engine against JAX ``backend="pallas"``: >= 0.995, the
  bar of tests/test_torch_crf_mean_field.py; the XLA engine keeps its bar of
  tests/test_torch_crf_reference_api.py, >= 0.99 (its bilateral filter
  rounds elsewhere than JAX's XLA engine).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from crf_scenes import make_scene
from deeplab_tpu import crf as JCRF
from deeplab_tpu.crf import dense_crf as JDC
from deeplab_tpu.kernels import crf_fused as JK

from deeplab_tpu_torch import crf as TCRF
from deeplab_tpu_torch.crf import dense_crf as TDC
from deeplab_tpu_torch.kernels import crf_fused as TK

PLANE_FLOOR, XLA_FLOOR = 0.995, 0.99


def _blur_inputs(B, ny, nx, cs_y, cs_x, L, per_image, seed=0):
    r = np.random.RandomState(seed)
    Z, P = ny * nx, cs_y * cs_x
    q = torch.from_numpy(r.rand(B * Z, L, P).astype(np.float32))
    gn = torch.from_numpy(
        0.5 + r.rand(B * Z if per_image else Z, 1, P).astype(np.float32))
    return q.to(torch.bfloat16), gn


def _jax_blur(q, gn, monkeypatch, **kw):
    """JAX ``gaussian_blur_planes`` in interpret mode, and the output of
    each of its ``pallas_call`` kernels in call order."""
    outs = []
    orig = JK.pl.pallas_call

    def recorder(*args, **kwargs):
        kernel = orig(*args, **kwargs)

        def call(*operands):
            out = kernel(*operands)
            outs.append(np.asarray(out, np.float32))
            return out
        return call
    monkeypatch.setattr(JK.pl, "pallas_call", recorder)
    with jax.disable_jit():
        got = JK.gaussian_blur_planes(
            jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(gn.numpy()), interpret=True, **kw)
    monkeypatch.undo()
    return np.asarray(got, np.float32), outs


def _close(got, want, rel, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    print(f"{what}: max_abs {err:.3e} of max {scale:.3e}")
    assert err <= rel * scale, (what, err, scale)


def _taps(sigma):
    return tuple(float(t) for t in TDC._gauss_taps(sigma))


# (cs_y, sigma, gn per image): the VOC cell heights 24/60/75 at r = 8 (the
# TPU's fallback; the port's row kernel on the card), gn per cell, and radii
# 18 and 30 past the row kernel's 16 on 64-row cells
FALLBACK = [(24, 3.0, False), (60, 3.0, False), (75, 3.0, False),
            (75, 3.0, True), (64, 7.0, False), (64, 12.0, True)]


@pytest.mark.parametrize("cs_y,sigma,per_image", FALLBACK)
def test_blur_passes_match_jax_fallback(cs_y, sigma, per_image,
                                        monkeypatch):
    B, ny, nx, cs_x, L = 2, 2, 2, 128, 5
    kw = dict(taps=_taps(sigma), B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    # The port's dispatch on the card: r = 8 with gn (Z, 1, P) takes the row
    # kernel at any cell height (the VOC heights 24, 60 and 75 included);
    # gn per cell and radii 18 and 30 keep the y and x passes.  JAX runs its
    # fallback kernels at all of these, so the passes' plain versions are
    # held to them below in every case.
    assert TK.row_kernel_fits(kw["taps"], cs_x, per_image) == (
        sigma == 3.0 and not per_image)
    q, gn = _blur_inputs(B, ny, nx, cs_y, cs_x, L, per_image)
    want, (jy, jx) = _jax_blur(q, gn, monkeypatch, **kw)
    np.testing.assert_array_equal(jx, want)
    y = TK.gaussian_blur_y_planes_reference(q, gn, **kw)
    assert y.dtype == torch.bfloat16
    _close(y, jy, TK.PLAIN_BF16_REL, f"y pass cs_y {cs_y} r {sigma}")
    # the x pass on the TPU's own y output: the same input on both sides
    x = TK.gaussian_blur_x_planes_reference(
        torch.from_numpy(jy).to(torch.bfloat16), **kw)
    assert x.dtype == torch.bfloat16
    _close(x, jx, TK.PLAIN_BF16_REL, f"x pass cs_y {cs_y} r {sigma}")
    # and the whole blur through the port's dispatch on the CPU
    _close(TK.gaussian_blur_planes(q, gn, **kw), want, TK.PLAIN_BF16_REL,
           "y then x")


@pytest.mark.parametrize("cs_y,sigma,per_image",
                         FALLBACK + [(64, 3.0, False), (32, 6.0, True)])
def test_y_then_x_is_the_blur_reference(cs_y, sigma, per_image):
    B, ny, nx, cs_x, L = 2, 2, 3, 128, 3
    kw = dict(taps=_taps(sigma), B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    q, gn = _blur_inputs(B, ny, nx, cs_y, cs_x, L, per_image, seed=1)
    yx = TK.gaussian_blur_x_planes_reference(
        TK.gaussian_blur_y_planes_reference(q, gn, **kw), **kw)
    full = TK.gaussian_blur_planes_reference(q, gn, **kw)
    assert yx.dtype == full.dtype == torch.bfloat16
    torch.testing.assert_close(yx, full, rtol=0, atol=0)


def test_blur_where_only_the_tpu_vmem_clause_declines(monkeypatch):
    """A (1, 64, 1024) batch at L = 21: nx = 8 cells of 64x128 make a row of
    2.75 MB, past the TPU row kernel's 2 MiB, so JAX runs its fallback; the
    port keeps the row kernel (its geometry fits) and equals JAX."""
    B, ny, nx, cs_y, cs_x, L = 1, 1, 8, 64, 128, 21
    kw = dict(taps=_taps(3.0), B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
    assert TK.row_kernel_fits(kw["taps"], cs_x)
    assert nx * L * cs_y * cs_x * 2 > JK._ROW_BLOCK_BYTES
    q, gn = _blur_inputs(B, ny, nx, cs_y, cs_x, L, False, seed=2)
    want, outs = _jax_blur(q, gn, monkeypatch, **kw)
    assert len(outs) == 2                  # JAX took the y and x kernels
    _close(TK.gaussian_blur_planes(q, gn, **kw), want, TK.PLAIN_BF16_REL,
           "row-bytes geometry")


def _plans(cfg, B, h, w, imgs=None):
    ctaps = JDC._cfg_color_taps(cfg)
    if imgs is None:
        imgs = np.zeros((B, h, w, 3), np.float32)
    jp = JDC._PallasPlan(jnp.asarray(imgs), cfg.sxy_bilateral, cfg.srgb,
                         cfg.color_step, cfg.splat_stride, ctaps=ctaps)
    tp = TDC.CellPlan(B, h, w, cfg.sxy_bilateral, cfg.srgb, cfg.color_step,
                      cfg.splat_stride, ctaps=TDC._cfg_color_taps(cfg))
    return jp, tp


@pytest.mark.parametrize("sxy,hw", [(16.0, (64, 64)), (40.0, (64, 120))])
def test_image_layout_blur_matches_jax(sxy, hw):
    """Cells narrower than 128 px (the notebook's sxy 16; sxy 40, what
    resolution_scale 2 makes of PRODUCTION_CONFIG): A = bf16(Q * bf16(gn)),
    two bf16 band products, back to cell planes."""
    B, L = 2, 5
    cfg = JCRF.CrfConfig(sxy_bilateral=sxy)
    jp, tp = _plans(cfg, B, *hw)
    assert tp.cs_x % 128 and (tp.cs_y, tp.cs_x) == (jp.cs_y, jp.cs_x)
    r = np.random.RandomState(3)
    q = torch.from_numpy(r.rand(B * tp.Z, L, tp.P).astype(np.float32)
                         ).to(torch.bfloat16)
    gn = tp.cells_v(TDC.gaussian_norm(hw, 3.0).permute(2, 0, 1)[None])
    taps = TDC._gauss_taps(3.0)
    np.testing.assert_array_equal(
        tp.uncells_v_wh(q.float(), L).numpy(),
        np.asarray(jp.uncells_v_wh(jnp.asarray(q.float().numpy()), L)))
    A = q * gn.repeat(B, 1, 1).to(torch.bfloat16)
    got = tp.cells_v(TDC._sep_conv_bwh_to_bhw(tp.uncells_v_wh(A, L), taps))
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    jA = jq * jnp.tile(jnp.asarray(gn.numpy()), (B, 1, 1)).astype(jq.dtype)
    want = jp.cells_v(JDC._sep_conv_bwh_to_bhw(jp.uncells_v_wh(jA, L),
                                               taps))
    assert got.dtype == torch.bfloat16
    _close(got, want, TK.PLAIN_BF16_REL, f"image-layout blur sxy {sxy}")


def test_narrow_cells_emit_their_subsampled_copies():
    """At 32x40 cells JAX's kernels emit no stride-subsampled attrs, Q0 or
    Q (its TPU shape-casts need 128-px cells) and XLA subsamples them; the
    port's kernels emit them, and they equal JAX's."""
    cfg = dataclasses.replace(JCRF.PRODUCTION_CONFIG, sxy_bilateral=40.0)
    B, H, W, L = 1, 64, 120, 5
    im, mask = make_scene(H, W, L, 4)
    jp, tp = _plans(cfg, B, H, W, im[None])
    assert (tp.cs_y, tp.cs_x, tp.stride) == (32, 40, 2)
    rgb = tp.cells_v(torch.from_numpy(im)[None].permute(0, 3, 1, 2))
    lab = tp.cells_v(torch.from_numpy(mask)[None, None].to(torch.int32))
    gn = tp.cells_v(TDC.gaussian_norm((H, W), 3.0).permute(2, 0, 1)[None])
    valid = tp.cells_v(torch.ones((B, 1, H, W)))
    geo = dict(nc=tp.nc, inv_step=tp.inv_step)
    Gn = tp.z_blur(TK.splat_planes(tp.subsample(rgb, 3),
                                   tp.subsample(valid, 1), L=1, **geo) * 4.0)
    kw = dict(L=L, stride=2, cs_y=tp.cs_y, cs_x=tp.cs_x, h=H, w=W,
              nx=tp.nx, Z=tp.Z, gt_prob=cfg.gt_prob)
    attrs, q0, attrs_s, q0_s = TK.slice_attrs_planes(
        rgb, Gn, gn, lab, ctaps=tp.bb_taps, **kw, **geo)
    gpad = np.zeros((tp.Z, JK._d_pad(tp.nc, 1), JK._c_pad(tp.nc)),
                    np.float32)
    gpad[:, :tp.nc, :tp.nc ** 2] = Gn.numpy()
    jouts = JK.slice_attrs_planes(
        jnp.asarray(rgb.numpy()), jnp.asarray(gpad), jp.Brg,
        jnp.asarray(gn.numpy()), jnp.asarray(lab.numpy()), nc=jp.nc,
        inv_step=jp.inv_step, bb_taps=jp.bb_taps, interpret=True, **kw)
    assert len(jouts) == 2                 # JAX's kernel emitted no copies
    for row in range(TK.ATTR_ROWS):
        rel = TK.PLAIN_BF16_REL if row in (TK.ATTR_BN, TK.ATTR_BSCALE) \
            else 1e-4
        _close(attrs_s[:, row], jp.subsample(jouts[0], TK.ATTR_ROWS)[:, row],
               rel, f"subsampled attrs row {row}")
    np.testing.assert_array_equal(
        q0_s.float().numpy(), np.asarray(jp.subsample(jouts[1], L),
                                         np.float32))
    # the step's subsampled Q against XLA's subsample of JAX's step
    rng = np.random.RandomState(5)
    q = torch.softmax(torch.from_numpy(rng.randn(*q0.shape).astype(
        np.float32) * 2), dim=1).to(torch.bfloat16)
    taps = _taps(cfg.sxy_gaussian)
    fg = tp.cells_v(TDC._sep_conv_bwh_to_bhw(tp.uncells_v_wh(
        q * gn.to(torch.bfloat16), L), taps))
    G = tp.z_blur(TK.splat_planes(attrs_s, tp.subsample(q, L), L=L,
                                  out_dtype=torch.bfloat16, **geo))
    step = dict(cg=cfg.compat_gaussian, cb=cfg.compat_bilateral,
                n_energy=1.0, p_energy=0.3, sub_stride=2, cs_y=tp.cs_y,
                cs_x=tp.cs_x)
    got = TK.mf_step_planes(attrs, G, fg, q, L=L, ctaps=tp.bb_taps, **step,
                            **geo)
    gpad = np.zeros((tp.Z, JK._d_pad(tp.nc, L), JK._c_pad(tp.nc)),
                    np.float32)
    gpad[:, :tp.nc * L, :tp.nc ** 2] = G.float().numpy()
    bf = jnp.bfloat16
    want = JK.mf_step_planes(
        jnp.asarray(attrs.numpy()), jnp.asarray(gpad).astype(bf), jp.Brg,
        jnp.asarray(fg.float().numpy()).astype(bf),
        jnp.asarray(q.float().numpy()).astype(bf), nc=jp.nc, L=L,
        inv_step=jp.inv_step, bb_taps=jp.bb_taps, interpret=True, **step)
    assert len(got) == 2 and len(want) == 1
    _close(got[1], jp.subsample(want[0], L), TK.PLAIN_BF16_REL,
           "subsampled step Q")


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def _batched(cfg, jcfg, H, W, L, seeds):
    ims, ms = zip(*[make_scene(H, W, L, s) for s in seeds])
    im, mask = np.stack(ims), np.stack(ms)
    want = np.asarray(JDC.mean_field_batched(jnp.asarray(im),
                                             jnp.asarray(mask), jcfg, L))
    got = TCRF.mean_field_batched(torch.from_numpy(im),
                                  torch.from_numpy(mask), cfg, L)
    assert got.dtype == torch.int32 and got.shape == mask.shape
    agree = _agree(got.numpy(), want)
    changed = 1 - _agree(want, mask)
    print(f"mask agreement with JAX {agree:.5f} (the CRF changed "
          f"{changed:.4f} of the pixels)")
    assert changed > 0.01
    return agree


@pytest.mark.parametrize("name,cfg,H,W,L", [
    # cs_y = 60 at the production config: on the card the row kernel
    ("production 120x256", TCRF.PRODUCTION_CONFIG, 120, 256, 21),
    # r = 18 on 64x128 cells
    ("sxy_gaussian 7", TCRF.CrfConfig(sxy_gaussian=7.0), 128, 256, 5),
    # the notebook's config: 16x16 cells, the image-layout blur
    ("sxy_bilateral 16", TCRF.CrfConfig(sxy_bilateral=16.0), 64, 64, 5),
])
def test_plane_engine_geometries_match_jax(name, cfg, H, W, L):
    jcfg = JCRF.CrfConfig(**dict(dataclasses.asdict(cfg), backend="pallas"))
    agree = _batched(cfg, jcfg, H, W, L, (11, 12))
    print(f"{name}: {agree:.5f}")
    assert agree >= PLANE_FLOOR, (name, agree)


def test_do_crf_at_cell_height_75_matches_jax():
    """150x200 at CrfConfig(): cs_y = 75, the VOC cell height."""
    im, mask = make_scene(150, 200, 5, 13)
    mask = np.where(mask == 3, 17, mask)              # sparse ids
    plan = TDC.CellPlan(1, 150, 200, 80.0, 13.0, 1.0)
    assert plan.cs_y == 75
    got = TCRF.do_crf(im, mask, zero_unsure=False, cfg=TCRF.CrfConfig(),
                      device="cpu")
    want = JCRF.do_crf(im, mask, zero_unsure=False,
                       cfg=JCRF.CrfConfig(backend="pallas"))
    assert got.shape == mask.shape and got.dtype == mask.dtype
    print(f"do_crf at 150x200: JAX {_agree(got, want):.5f}, the CRF "
          f"changed {1 - _agree(want, mask):.4f}")
    assert 1 - _agree(want, mask) > 0.01
    assert _agree(got, want) >= PLANE_FLOOR


ENGINES = [("pallas", PLANE_FLOOR), ("xla", XLA_FLOOR)]


@pytest.mark.parametrize("engine,floor", ENGINES)
def test_resolution_scale_mean_field_batched(engine, floor):
    """PRODUCTION_CONFIG at resolution_scale 2 on 128x256: the CRF at 64x128
    with sxy_bilateral 40 (32x40 cells on the plane engine) and the masks
    repeated back."""
    cfg = dataclasses.replace(TCRF.PRODUCTION_CONFIG, resolution_scale=2,
                              backend="auto" if engine == "pallas"
                              else "xla")
    jcfg = dataclasses.replace(JCRF.PRODUCTION_CONFIG, resolution_scale=2,
                               backend=engine)
    agree = _batched(cfg, jcfg, 128, 256, 21, (21, 22))
    assert agree >= floor, (engine, agree)


@pytest.mark.parametrize("engine,floor", ENGINES)
def test_resolution_scale_mean_field(engine, floor):
    im, mask = make_scene(96, 128, 5, 14)
    U = np.asarray(JDC.unary_from_labels(jnp.asarray(mask), 5, 0.7, False))
    U = (U + np.random.RandomState(8).rand(*U.shape) * 0.5).astype(
        np.float32)
    cfg = dict(resolution_scale=2, backend=engine)
    want = np.asarray(JDC.mean_field(jnp.asarray(im), jnp.asarray(U),
                                     JCRF.CrfConfig(**cfg), 5))
    got = TCRF.mean_field(torch.from_numpy(im), torch.from_numpy(U),
                          TCRF.CrfConfig(**cfg), 5)
    assert got.dtype == torch.float32 and got.shape == (96 * 128, 5)
    # each 2x2 block repeats one pixel's Q
    q = got.reshape(48, 2, 64, 2, 5)
    assert bool((q == q[:, :1, :, :1]).all())
    agree = _agree(got.argmax(-1).numpy(), want.argmax(-1))
    moved = _agree(want.argmax(-1), U.argmin(-1))
    print(f"{engine}: argmax agreement with JAX {agree:.5f}; JAX kept "
          f"{moved:.4f} of the unary's argmin")
    assert moved < 0.99
    assert agree >= floor, (engine, agree)


@pytest.mark.parametrize("engine,floor", ENGINES)
def test_resolution_scale_do_crf(engine, floor):
    """An odd size (75x101): the subsampled image is 38x51 and the
    upsampled masks are cropped back."""
    im, mask = make_scene(75, 101, 4, 15)
    cfg = dict(resolution_scale=2, backend=engine)
    got = TCRF.do_crf(im, mask, zero_unsure=False,
                      cfg=TCRF.CrfConfig(**cfg), device="cpu")
    want = JCRF.do_crf(im, mask, zero_unsure=False,
                       cfg=JCRF.CrfConfig(**cfg))
    assert got.shape == mask.shape and got.dtype == mask.dtype
    print(f"{engine}: do_crf agreement with JAX {_agree(got, want):.5f}")
    assert _agree(got, want) >= floor
