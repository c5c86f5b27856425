"""The port's CRF configs, cell plan and the plain versions of its four
kernels against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True``)
on the same inputs, made with numpy from a seed (the structured scenes of
``tests/crf_scenes.py``) and carried through the port's own pipeline.  The
JAX grids carry the TPU's tile padding (C to 256, D to 16-multiples); the
comparisons take the valid ``[:nc*L, :nc*nc]`` part.

Tolerances, each from the rounding the two sides share: both take the same
bf16-rounded operands, whose products are exact in f32, and differ only in
the order of f32 sums.  f32 outputs: relative 1e-4 of the largest value
(sums of ~2000 terms; measured 1.6e-5 on the norm grid, 0 on the exact
attrs rows).  bf16 outputs, and the attrs rows sliced from a bf16-rounded
grid (b_norm, b_scale): one bf16 rounding can flip, so 2 bf16 ulps of the
largest value, 2^-7 relative (measured: at most 1 ulp; b_norm 3e-4).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crf_scenes import make_scene
from deeplab_tpu import crf as JCRF
from deeplab_tpu.crf import dense_crf as JDC
from deeplab_tpu.kernels import crf_fused as JK

from deeplab_tpu_torch import crf as TCRF
from deeplab_tpu_torch.crf import dense_crf as TDC
from deeplab_tpu_torch.kernels import crf_fused as TK

B, H, W, L = 2, 128, 256, 21
F32_REL = 1e-4
BF16_REL = 2 * 2.0 ** -8


@pytest.mark.parametrize("name", ["FAITHFUL_CONFIG", "FAST_FAITHFUL_CONFIG",
                                  "THROUGHPUT_CONFIG", "PRODUCTION_CONFIG"])
def test_named_configs_match_jax(name):
    got = dataclasses.asdict(getattr(TCRF, name))
    want = dataclasses.asdict(getattr(JCRF, name))
    assert got == want


@pytest.mark.parametrize("mode", ["gaussian", "lsq", "nnls"])
@pytest.mark.parametrize("step", [1.0, 1.5, 1.7, 2.5])
def test_color_band_taps_match_jax(mode, step):
    np.testing.assert_array_equal(TDC.color_band_taps(step, mode),
                                  JDC.color_band_taps(step, mode))


def test_unary_and_gaussian_norm_match_jax():
    lab = np.random.RandomState(0).randint(0, 5, 64)
    for zu in (True, False):
        np.testing.assert_allclose(
            TDC.unary_from_labels(torch.from_numpy(lab), 5, 0.7, zu).numpy(),
            np.asarray(JDC.unary_from_labels(jnp.asarray(lab), 5, 0.7, zu)),
            rtol=1e-6)
    np.testing.assert_allclose(TDC.gaussian_norm((37, 61), 3.0).numpy(),
                               np.asarray(JDC.gaussian_norm((37, 61), 3.0)),
                               rtol=1e-6)


def _plans(cfg, b, h, w, imgs=None):
    ctaps = JDC._cfg_color_taps(cfg)
    if imgs is None:
        imgs = np.zeros((b, h, w, 3), np.float32)
    jp = JDC._PallasPlan(jnp.asarray(imgs), cfg.sxy_bilateral, cfg.srgb,
                         cfg.color_step, cfg.splat_stride, ctaps=ctaps)
    tp = TDC.CellPlan(b, h, w, cfg.sxy_bilateral, cfg.srgb, cfg.color_step,
                      cfg.splat_stride, ctaps=TDC._cfg_color_taps(cfg))
    return jp, tp


@pytest.mark.parametrize("hw", [(512, 512), (128, 256), (96, 96), (80, 120),
                                (64, 256)])
def test_plan_geometry_matches_jax(hw):
    cfg = TCRF.PRODUCTION_CONFIG
    jp, tp = _plans(cfg, 1, *hw)
    for k in ("cs_y", "cs_x", "ny", "nx", "nc", "stride", "Z", "P",
              "inv_step", "bb_taps"):
        assert getattr(tp, k) == getattr(jp, k), k
    np.testing.assert_array_equal(tp.S.numpy(), np.asarray(jp.S))
    # the joint (r, g) color blur, bf16-rounded as the TPU multiplies by
    # it: dense for the plain versions, and as the kernels' stencil
    C, n = tp.nc ** 2, len(tp.bb_taps)
    brg = TK._bf(torch.from_numpy(np.array(jp.Brg)[:C, :C])).numpy()
    np.testing.assert_array_equal(
        TK._brg_bf16(tp.nc, tp.bb_taps, "cpu").numpy(), brg)
    R, c1 = n // 2, (n // 2) * tp.nc + n // 2
    cols = [(R + dr) * tp.nc + R + dg for dr in range(-R, R + 1)
            for dg in range(-R, R + 1)]
    pack = TK._color_taps_host(tp.bb_taps)
    np.testing.assert_array_equal(pack[:n * n], brg[c1, cols])
    np.testing.assert_array_equal(pack[n * n:], np.asarray(tp.bb_taps,
                                                           np.float32))


def test_cell_layouts_match_jax():
    jp, tp = _plans(TCRF.PRODUCTION_CONFIG, 2, 80, 120)
    x = np.random.RandomState(1).rand(2, 5, 80, 120).astype(np.float32)
    cj = np.asarray(jp.cells_v(jnp.asarray(x)))
    ct = tp.cells_v(torch.from_numpy(x))
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(tp.uncells_v(ct, 5).numpy(),
                                  np.asarray(jp.uncells_v(jnp.asarray(cj), 5)))
    np.testing.assert_array_equal(tp.subsample(ct, 5).numpy(),
                                  np.asarray(jp.subsample(jnp.asarray(cj), 5)))
    g = np.random.RandomState(2).rand(2 * tp.Z, 7, 9).astype(np.float32)
    np.testing.assert_allclose(tp.z_blur(torch.from_numpy(g)).numpy(),
                               np.asarray(jp.z_blur(jnp.asarray(g))),
                               rtol=1e-6)


# ------------------------------------------------ kernels, plain vs JAX ----

def _jpad(grid, nc, Lv):
    """(Z, nc*Lv, nc^2) -> the TPU's zero-padded (Z, d_pad, c_pad)."""
    g = np.asarray(grid.float().numpy() if torch.is_tensor(grid) else grid)
    out = np.zeros((g.shape[0], JK._d_pad(nc, Lv), JK._c_pad(nc)), g.dtype)
    out[:, :g.shape[1], :g.shape[2]] = g
    return out


def _close(got, want, rel, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    print(f"{what}: max_abs {err:.3e} of max {scale:.3e}")
    assert err <= rel * scale, (what, err, scale)


class Stage:
    """One batch carried through the port's plain pipeline, keeping every
    kernel's inputs; the JAX plan beside it."""

    def __init__(self, cfg):
        ims, ms = zip(*[make_scene(H, W, L, s) for s in (21, 22)])
        self.im, self.mask = np.stack(ims), np.stack(ms)
        self.jp, self.tp = _plans(cfg, B, H, W, self.im)
        tp = self.tp
        self.cfg = cfg
        self.rgb = tp.cells_v(torch.from_numpy(self.im).permute(0, 3, 1, 2))
        self.lab = tp.cells_v(torch.from_numpy(self.mask)[:, None].to(
            torch.int32))
        self.gn = tp.cells_v(TDC.gaussian_norm((H, W), 3.0).permute(
            2, 0, 1)[None])
        self.valid = tp.cells_v(torch.ones((B, 1, H, W)))
        self.geo = dict(nc=tp.nc, inv_step=tp.inv_step)
        s = tp.stride
        rgb_s = tp.subsample(self.rgb, 3) if s > 1 else self.rgb
        val_s = tp.subsample(self.valid, 1) if s > 1 else self.valid
        self.norm_in = (rgb_s, val_s)
        Gn = TK.splat_planes(*self.norm_in, L=1, **self.geo) * float(s * s)
        self.Gn = tp.z_blur(Gn)
        self.attrs_kw = dict(
            L=L, ctaps=tp.bb_taps, stride=s, cs_y=tp.cs_y, cs_x=tp.cs_x,
            h=H, w=W, nx=tp.nx, Z=tp.Z, gt_prob=cfg.gt_prob, **self.geo)
        outs = TK.slice_attrs_planes(self.rgb, self.Gn, self.gn, self.lab,
                                     **self.attrs_kw)
        self.attrs = outs[0]
        self.attrs_sub = outs[2] if s > 1 else outs[0]
        # a Q state away from Q0's two values: softmax of seeded logits
        rng = np.random.RandomState(3)
        q = torch.softmax(torch.from_numpy(
            rng.randn(*outs[1].shape).astype(np.float32) * 2), dim=1)
        self.Q = q.to(torch.bfloat16)
        self.Q_sub = tp.subsample(self.Q, L) if s > 1 else self.Q
        self.taps = tuple(float(t) for t in TDC._gauss_taps(3.0))
        self.blur_kw = dict(taps=self.taps, B=B, ny=tp.ny, nx=tp.nx,
                            cs_y=tp.cs_y, cs_x=tp.cs_x)
        self.fg = TK.gaussian_blur_planes(self.Q, self.gn, **self.blur_kw)
        G = TK.splat_planes(self.attrs_sub, self.Q_sub, L=L,
                            out_dtype=torch.bfloat16, **self.geo)
        self.G = tp.z_blur(G)


@pytest.fixture(scope="module")
def prod():
    return Stage(TCRF.PRODUCTION_CONFIG)


def _j(t):
    return jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                       else t.numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else None)


def test_splat_norm_pass_matches_jax(prod):
    got = TK.splat_planes_reference(*prod.norm_in, L=1, **prod.geo)
    want = JK.splat_planes(*(jnp.asarray(t.numpy()) for t in prod.norm_in),
                           nc=prod.tp.nc, L=1, inv_step=prod.tp.inv_step,
                           interpret=True)
    nc = prod.tp.nc
    _close(got, np.asarray(want)[:, :nc, :nc * nc], F32_REL, "splat norm")


def test_splat_iteration_pass_matches_jax(prod):
    got = TK.splat_planes_reference(prod.attrs_sub, prod.Q_sub, L=L,
                                    out_dtype=torch.bfloat16, **prod.geo)
    want = JK.splat_planes(jnp.asarray(prod.attrs_sub.numpy()),
                           _j(prod.Q_sub), nc=prod.tp.nc, L=L,
                           inv_step=prod.tp.inv_step, out_dtype=jnp.bfloat16,
                           interpret=True)
    nc = prod.tp.nc
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32)[:, :nc * L, :nc * nc],
           BF16_REL, "splat iteration")


@pytest.mark.parametrize("stride", [2, 1])
def test_slice_attrs_matches_jax(prod, stride):
    kw = dict(prod.attrs_kw, stride=stride)
    got = TK.slice_attrs_planes_reference(prod.rgb, prod.Gn, prod.gn,
                                          prod.lab, **kw)
    jp = prod.jp
    want = JK.slice_attrs_planes(
        jnp.asarray(prod.rgb.numpy()), jnp.asarray(_jpad(prod.Gn, jp.nc, 1)),
        jp.Brg, jnp.asarray(prod.gn.numpy()), jnp.asarray(prod.lab.numpy()),
        nc=jp.nc, L=L, inv_step=jp.inv_step, bb_taps=jp.bb_taps,
        stride=stride, cs_y=jp.cs_y, cs_x=jp.cs_x, h=H, w=W, nx=jp.nx,
        Z=jp.Z, gt_prob=prod.cfg.gt_prob, interpret=True)
    assert len(got) == len(want) == (4 if stride > 1 else 2)
    for i, (g, w_) in enumerate(zip(got, want)):
        if g.dtype == torch.bfloat16:       # Q0: two closed-form values
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w_, np.float32))
            continue
        for row in range(TK.ATTR_ROWS):     # each attrs row on its own scale
            # b_norm and b_scale come from a slice of the bf16-rounded
            # blurred grid: one flipped rounding there moves them by up to
            # 2^-8 relative, so they get the bf16 tolerance
            rel = BF16_REL if row in (TK.ATTR_BN, TK.ATTR_BSCALE) else F32_REL
            _close(g[:, row], np.asarray(w_)[:, row], rel,
                   f"slice_attrs[{i}] row {row}")


def test_gaussian_blur_matches_jax(prod):
    got = TK.gaussian_blur_planes_reference(prod.Q, prod.gn, **prod.blur_kw)
    want = JK.gaussian_blur_planes(_j(prod.Q), jnp.asarray(prod.gn.numpy()),
                                   interpret=True, **prod.blur_kw)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL, "gaussian blur")


@pytest.mark.parametrize("sub_stride", [2, 1])
def test_mf_step_matches_jax(prod, sub_stride):
    cfg, jp = prod.cfg, prod.jp
    n_e = -math.log((1.0 - cfg.gt_prob) / (L - 1))
    p_e = -math.log(cfg.gt_prob)
    kw = dict(cg=cfg.compat_gaussian, cb=cfg.compat_bilateral, n_energy=n_e,
              p_energy=p_e, sub_stride=sub_stride, cs_y=jp.cs_y,
              cs_x=jp.cs_x)
    got = TK.mf_step_planes_reference(prod.attrs, prod.G, prod.fg, prod.Q,
                                      L=L, ctaps=prod.tp.bb_taps, **kw,
                                      **prod.geo)
    want = JK.mf_step_planes(
        jnp.asarray(prod.attrs.numpy()),
        jnp.asarray(_jpad(prod.G, jp.nc, L)).astype(jnp.bfloat16), jp.Brg,
        _j(prod.fg), _j(prod.Q), nc=jp.nc, L=L, inv_step=jp.inv_step,
        bb_taps=jp.bb_taps, chunk=jp.P, interpret=True, **kw)
    assert len(got) == len(want) == (2 if sub_stride > 1 else 1)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        _close(g, w_, BF16_REL, f"mf_step[{i}]")


def test_plain_versions_record_every_call_and_compare():
    """The recorder and the comparison that hold each kernel to its plain
    version on the card (chip_smoke.py, tests/test_torch_kernels_gpu.py)."""
    cfg = TCRF.PRODUCTION_CONFIG
    im, mask = make_scene(64, 256, 5, 4)
    im, mask = torch.from_numpy(im)[None], torch.from_numpy(mask)[None]
    wrappers = {n: getattr(TK, n) for n in TK.KERNELS}
    launches = {n: f.launches for n, f in wrappers.items()}
    with TK.plain_versions() as calls:
        got = TCRF.mean_field_batched(im, mask, cfg, 5)
    assert {n: getattr(TK, n) for n in TK.KERNELS} == wrappers
    assert {n: f.launches for n, f in wrappers.items()} == launches
    it = cfg.n_iters
    assert {n: len(c) for n, c in calls.items()} == {
        "splat_planes": 1 + it, "slice_attrs_planes": 1,
        "gaussian_blur_planes": it, "mf_step_planes": it}
    torch.testing.assert_close(got, TCRF.mean_field_batched(im, mask, cfg, 5),
                               rtol=0, atol=0)
    for name, recorded in calls.items():
        for args, kw, out in recorded:
            assert TK.max_err_vs_plain(name, out, out) == (0.0, True)
    # one f32 attrs row off by 2e-4 of its largest value fails; one bf16
    # ulp of the largest step output passes
    attrs = calls["slice_attrs_planes"][0][2]
    off = list(attrs)
    off[0] = off[0].clone()
    off[0][:, TK.ATTR_GN] += 2e-4 * off[0][:, TK.ATTR_GN].abs().max()
    assert not TK.max_err_vs_plain("slice_attrs_planes", tuple(off),
                                   attrs)[1]
    q = calls["mf_step_planes"][0][2]
    ulp = (q[0].float() * (1 + 2.0 ** -8)).to(torch.bfloat16)
    assert TK.max_err_vs_plain("mf_step_planes", (ulp,) + q[1:], q)[1]
