"""The launch plans of the redesigned kernels, on the CPU.

``fused_mbconv``'s plan (``kernels/fused_mbconv.py::mbconv_plan``), the
CRF row blur's (``kernels/crf_fused.py::blur_plan``), the blur's y and x
passes' (``pass_plan``), the splat's (``splat_plan``), the mean-field
step's (``step_plan``), ``slice_planes``' (``slice_plan``), the training
block's halo phases' (``kernels/fused_mbconv_train.py::train_plan``) and
``fused_dw_bn_relu6``'s (``kernels/fused_dw.py::dw_plan``) are
plain Python that the CUDA launchers check and never recompute
differently.  Here: every
main-path shape fits in a block's 232,448 bytes of shared memory; the tiles,
warps, chunks and label groups cover every output exactly once, ragged
edges included (the kernels' index arithmetic, mirrored); the recompute
factors that the sources' headers state are the plans' own; the step's
fused form runs exactly where its grid fits; a numpy model of the splat's
binning (counting sort, pieces of one key) sums to the plain version; and
the step's label-innermost scratch maps every grid value once; and
``fused_dw``'s ring of input rows holds each row from its copy to its last
read (the kernel's slot counters, mirrored).
"""

import itertools

import numpy as np
import pytest
import torch

from deeplab_tpu_torch import crf as CRF
from deeplab_tpu_torch.crf import dense_crf as DC
from deeplab_tpu_torch.kernels import crf_fused as CK
from deeplab_tpu_torch.kernels import fused_dw as FDW
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
from deeplab_tpu_torch.models import mobilenetv2 as M

LIMIT = 232448


def _main_path_shapes():
    """Distinct (Cin, Ce, Cout, rate, map side) of the fused blocks of the
    512x512 MobileNetV2 net (the 14 stride-1 expand blocks)."""
    out, c, st = set(), 32, 2
    for filters, stride, expansion, block_id, _, rate in M.BLOCK_TABLE:
        st *= stride
        cout = M.make_divisible(filters, 8)
        if block_id and stride == 1:
            out.add((c, expansion * c, cout, rate, 512 // st))
        c = cout
    return sorted(out)


MAIN = _main_path_shapes()
# tests/test_torch_kernels_gpu.py's fused_mbconv shapes: (Cin, Ce, Cout,
# rate, H, W) at B=2
GPU_TEST_SHAPES = [(24, 144, 24, 1, 20, 36), (32, 200, 64, 2, 16, 13),
                   (16, 96, 16, 4, 8, 8), (64, 384, 64, 2, 21, 19),
                   (96, 576, 96, 4, 19, 35), (20, 100, 24, 2, 30, 17)]


def test_main_path_has_nine_block_shapes():
    assert len(MAIN) == 9
    assert (160, 960, 320, 4, 64) in MAIN and (24, 144, 24, 1, 128) in MAIN


def _mbconv_cases():
    # the plan does not depend on the dtype: "mixed" and bf16 share it
    for B in (1, 8, 16):
        for cin, ce, cout, rate, hw in MAIN:
            yield B, hw, hw, cin, ce, cout, rate
    for cin, ce, cout, rate, H, W in GPU_TEST_SHAPES:
        yield 2, H, W, cin, ce, cout, rate
    for cin, ce, cout, rate, _ in MAIN:
        for H, W in ((37, 21), (26, 7)):
            yield 2, H, W, cin, ce, cout, rate


@pytest.mark.parametrize("case", list(_mbconv_cases()))
def test_mbconv_plan_fits_and_is_instantiated(case):
    B, H, W, cin, ce, cout, rate = case
    p = FM.mbconv_plan(B, H, W, cin, ce, cout, rate)
    assert p.smem <= LIMIT
    assert p.smem == FM.mbconv_smem(H, W, cin, cout, rate, p.th, p.tw, p.ck,
                                    p.stages)
    assert (p.th, p.tw) in FM.MBCONV_TILES and p.ck in FM.MBCONV_CHUNKS
    assert p.stages in (2, 3)
    tp = p.th * p.tw
    assert p.nt in FM.MBCONV_NT[tp]
    assert p.nt * (FM.MBCONV_WARPS * 16 // tp) * 8 >= cout
    assert p.grid == (p.tiles_y * p.tiles_x, B)
    assert p.grid[1] <= 65535


def _kernel_coverage(H, W, th, tw, rate, cout, nt):
    """The kernel's tile, halo-box, warp and n-tile arithmetic
    (csrc/fused_mbconv.cu), mirrored: returns the count of each output
    pixel, the largest in-image halo box, and the count of each (pixel of
    a tile, n-tile) that the warps' accumulators hold."""
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    seen = {}
    nv_max = 0
    for blk in range(tiles_x * tiles_y):
        ty0, tx0 = (blk // tiles_x) * th, (blk % tiles_x) * tw
        sy0, sy1 = max(ty0 - rate, 0), min(ty0 + th + rate, H)
        sx0, sx1 = max(tx0 - rate, 0), min(tx0 + tw + rate, W)
        nv_max = max(nv_max, (sy1 - sy0) * (sx1 - sx0))
        for p in range(th * tw):
            gy, gx = ty0 + p // tw, tx0 + p % tw
            if gy < H and gx < W:
                seen[gy, gx] = seen.get((gy, gx), 0) + 1
                # every tap inside the image lies in the halo box
                for i, j in itertools.product(range(3), range(3)):
                    yy, xx = gy + (i - 1) * rate, gx + (j - 1) * rate
                    if 0 <= yy < H and 0 <= xx < W:
                        assert sy0 <= yy < sy1 and sx0 <= xx < sx1
    wm_n = th * tw // 16
    acc = {}
    for warp in range(FM.MBCONV_WARPS):
        wm, wn = warp % wm_n, warp // wm_n
        for j in range(nt):
            ntile = wn * nt + j
            if ntile >= cout // 8:
                continue
            for row in range(16):
                key = (wm * 16 + row, ntile)
                acc[key] = acc.get(key, 0) + 1
    return seen, nv_max, acc


@pytest.mark.parametrize("case", [
    (8, 64, 64, 160, 960, 160, 4), (8, 64, 64, 160, 960, 320, 4),
    (8, 64, 64, 64, 384, 64, 2), (1, 128, 128, 24, 144, 24, 1),
    (2, 37, 21, 96, 576, 160, 2), (2, 26, 7, 32, 192, 64, 1),
    (2, 19, 35, 96, 576, 96, 4), (2, 8, 8, 16, 96, 16, 4)])
def test_mbconv_tiles_cover_every_output_once(case):
    B, H, W, cin, ce, cout, rate = case
    p = FM.mbconv_plan(B, H, W, cin, ce, cout, rate)
    seen, nv_max, acc = _kernel_coverage(H, W, p.th, p.tw, rate, cout, p.nt)
    assert len(seen) == H * W and set(seen.values()) == {1}
    # the halo box fits the rows the plan allocates for x and e
    rows = -(-min(p.th + 2 * rate, H) * min(p.tw + 2 * rate, W) // 16) * 16
    assert -(-nv_max // 16) * 16 <= rows
    # the warps hold each (tile pixel, n-tile) exactly once
    assert len(acc) == p.th * p.tw * (cout // 8)
    assert set(acc.values()) == {1}


@pytest.mark.parametrize("tile,rate,factor", [
    ((8, 8), 1, 1.64), ((16, 16), 1, 1.25), ((8, 8), 2, 2.13),
    ((16, 16), 2, 1.44), ((8, 8), 4, 3.52), ((8, 16), 4, 2.58)])
def test_mbconv_halo_factor_stated_in_the_header(tile, rate, factor):
    """csrc/fused_mbconv.cu states these for a 64x64 map; the plan's halo
    is the expanded pixels (in-image boxes in whole m-tiles of 16) per
    output pixel, which a brute count reproduces."""
    th, tw = tile
    got = FM.mbconv_halo(64, 64, th, tw, rate)
    assert abs(got - factor) <= 0.005
    total = 0
    for ty0 in range(0, 64, th):
        for tx0 in range(0, 64, tw):
            n = ((min(ty0 + th + rate, 64) - max(ty0 - rate, 0))
                 * (min(tx0 + tw + rate, 64) - max(tx0 - rate, 0)))
            total += -(-n // 16) * 16
    assert total / 64 ** 2 == got
    with open(FM.__file__.replace("fused_mbconv.py",
                                  "csrc/fused_mbconv.cu")) as f:
        header = f.read().split("#include")[0]
    assert f"{factor:.2f}x" in header


def test_mbconv_main_path_plans_at_the_served_batch():
    """The main path's plans at B=8 use the larger tiles where they fit:
    no 8x8 tile except for Cout = 320, whose accumulator only the 64-pixel
    tile's four warp columns hold."""
    for cin, ce, cout, rate, hw in MAIN:
        p = FM.mbconv_plan(8, hw, hw, cin, ce, cout, rate)
        assert (p.th * p.tw == 64) == (cout == 320), (cin, ce, cout, p)


VOC_HEIGHTS = (375, 500, 360)   # VOC photos: cells of 75, 50 and 72 rows


def _row_blur_geometries():
    """Every (cs_y, cs_x, taps) that gaussian_blur_planes sends to the row
    kernel at the three configs, images from 128 to 1024 px a side and the
    VOC heights."""
    out = set()
    for cfg in (CRF.PRODUCTION_CONFIG, CRF.FAST_FAITHFUL_CONFIG,
                CRF.THROUGHPUT_CONFIG):
        taps = DC._gauss_taps(cfg.sxy_gaussian)
        for h in list(range(128, 1025, 8)) + list(VOC_HEIGHTS):
            for w in (128, 500, 1024):
                plan = DC.CellPlan(1, h, w, cfg.sxy_bilateral, cfg.srgb,
                                   cfg.color_step, cfg.splat_stride)
                if CK.row_kernel_fits(taps, plan.cs_x):
                    out.add((plan.cs_y, plan.cs_x, len(taps)))
    return sorted(out)


ROW_GEOMETRIES = _row_blur_geometries()


def test_row_blur_geometries_are_found():
    assert (64, 128, 17) in ROW_GEOMETRIES
    assert {g[0] for g in ROW_GEOMETRIES} >= {64, 80, 75, 50, 72}


def test_blur_plan_fits_every_cell_height():
    """CellPlan's heights at 128 px (40 to 80 rows, sxy_bilateral 80) each
    fit whole in one row-kernel block, at every label count of the configs
    and B = 1 and 8; the y pass's windows round a height up to blur_ry rows,
    all of them staged."""
    heights = {DC.CellPlan(1, h, 500, 80.0, 13.0, 1.5).cs_y
               for h in range(40, 1200)}
    assert heights == set(range(40, 81))
    for cs_y in sorted(heights):
        for B, L in ((1, 1), (8, 21), (8, 2)):
            p = CK.blur_plan(B, 5, 4, cs_y, 128, L, 17)
            assert (p.ty, p.strips) == (cs_y, 1)
            assert p.smem == CK.blur_smem(cs_y, 128, 17) <= LIMIT


@pytest.mark.parametrize("geom", ROW_GEOMETRIES)
@pytest.mark.parametrize("L", [1, 2, 21])
def test_blur_plan_fits_and_covers_each_output_once(geom, L):
    cs_y, cs_x, n = geom
    B, ny, nx = 2, 3, 2
    p = CK.blur_plan(B, ny, nx, cs_y, cs_x, L, n)
    assert p.smem <= LIMIT and p.smem == CK.blur_smem(p.ty, cs_x, n)
    assert p.grid == (B * ny * nx, p.strips, p.groups)
    # the kernel's strips (rows y0 .. y0 + min(ty, cs_y - y0)) and label
    # groups cover every row and label once
    rows = [y for s in range(p.strips)
            for y in range(s * p.ty, s * p.ty + min(p.ty, cs_y - s * p.ty))]
    assert rows == list(range(cs_y))
    labels = [l for g in range(p.groups)
              for l in range(g * p.lg, min(L, (g + 1) * p.lg))]
    assert labels == list(range(L))
    # one thread per y-pass window (column pair x blur_ry rows), in whole
    # warps, at most BLUR_MAX_THREADS a block
    assert p.threads % 32 == 0 and 32 <= p.threads <= CK.BLUR_MAX_THREADS
    windows = (cs_x + 2 * (n // 2)) // 2 * -(-p.ty // CK.blur_ry(n))
    rounds = -(-windows // p.threads)
    assert rounds == -(-windows // CK.BLUR_MAX_THREADS)


def test_blur_plan_whole_cells_and_header_factor():
    """At production (64x128 cells, 17 taps) a block takes a whole cell and
    reads 1.41x the cell's pixels (its 2r halo), as the source's header
    states; at B=8 all 21 labels share a gn tile, the 256 blocks fit one
    wave of two blocks an SM, and each of the 288 threads holds one y-pass
    window; at B=1 the labels split so that the blocks still fill the
    card."""
    p = CK.blur_plan(8, 8, 4, 64, 128, 21, 17)
    assert (p.ty, p.strips, p.lg, p.groups, p.wp, p.threads) == (
        64, 1, 21, 1, 144, 288)
    assert round((p.ty + 16) * (128 + 16) / (64 * 128), 2) == 1.41
    assert 2 * (p.smem + 1024) <= 233472
    assert p.BZ * p.groups <= CK.BLUR_SLOTS
    p1 = CK.blur_plan(1, 8, 4, 64, 128, 21, 17)
    assert p1.groups == 7 and p1.BZ * p1.groups <= CK.BLUR_SLOTS
    with open(CK.__file__.replace("crf_fused.py", "csrc/crf_fused.cu")) as f:
        assert "1.41x at 64x128" in f.read()


def test_blur_plan_splits_tall_cells_into_even_strips():
    p = CK.blur_plan(1, 1, 1, 512, 512, 3, 33)
    assert p.strips > 1 and p.smem <= LIMIT
    assert p.ty == -(-512 // p.strips)


# ---------------------------------------------------------------------------
# slice_planes and the spatial blur's y and x passes.

SLICE_NC = tuple(range(9, 22))        # the configs' 9-21 and every nc between
# P of the XLA engine's cells: 80x80 (sxy 80), 16x16 (sxy 16), 15x15
SLICE_P = (6400, 256, 225)


@pytest.mark.parametrize("nc", SLICE_NC)
def test_slice_plan_fits_and_covers_each_cell_label_and_pixel_once(nc):
    """At every label count 1-32 and cell size: the block's layout fits and
    is the plan's, its planes padded; groups of lg labels, blurred lb a
    round (lgp >= lg a grid point), and pixel splits (chunks s, s + splits,
    ... of SLICE_THREADS) cover every (label, pixel) of a cell once; the
    staged planes keep their offsets within 16 bytes, and a plane's
    cp.async items (16-byte words, then 4-byte ends) cover it once.  A
    49-cell image gives two blocks an SM where its labels allow, and at
    least one an SM where its labels and pixels allow, splitting a cell's
    pixels no further than that (blocks past one an SM measured slower,
    PERF.md §6)."""
    C = nc * nc
    T = CK.SLICE_THREADS
    for L in range(1, 33):
        for P in SLICE_P:
            p = CK.slice_plan(49, P, L, nc)
            assert p.pad
            assert p.smem == CK.slice_smem(nc, L, p.lg, p.lb, p.pad)
            assert p.smem <= LIMIT
            assert 1 <= p.lb <= min(p.lg, CK.SLICE_LB)
            assert 1 <= p.lg <= CK.SLICE_LG_MAX
            assert p.lgp == CK.slice_lgp(p.lg) >= p.lg and 2 * p.lgp <= 16
            assert p.grid == (49, p.groups, p.splits)
            labels = sorted(g * p.lg + j0 + i for g in range(p.groups)
                            for j0 in range(0, min(p.lg, L - g * p.lg), p.lb)
                            for i in range(min(p.lb,
                                               min(p.lg, L - g * p.lg) - j0)))
            assert labels == list(range(L))
            pixels = sorted(c0 + i for s in range(p.splits)
                            for c0 in range(s * T, P, T * p.splits)
                            for i in range(min(T, P - c0)))
            assert pixels == list(range(P))
            chunks = -(-P // T)
            assert p.splits <= max(1, chunks)
            assert p.groups >= min(L, -(-2 * CK.SLICE_SLOTS // 49))
            blocks = 49 * p.groups * p.splits
            assert blocks <= CK.SLICE_SLOTS or p.splits == 1
            assert blocks >= min(CK.SLICE_SLOTS // 49 * 49, 49 * L * chunks)
        xp = CK.slice_xp(nc, L)
        xl = CK.slice_xl(nc, xp)
        assert xp >= C and (xp - L * C) % 4 == 0
        assert xl % 4 == 0 and xl >= nc * xp + 3
        vpp = C // 4 + 6                    # the kernel's items a plane
        for mis in range(4):      # a label's first plane, mod 16 bytes
            for b in range(nc):
                dev = mis + b * L * C       # floats from a 16-byte line
                sm = xl + mis + b * xp      # the round's second label
                assert dev % 4 == sm % 4
                head = min(C, (4 - sm % 4) % 4)
                body = (C - head) // 4
                ends = C - 4 * body
                assert body + ends <= vpp
                covered = []
                for k in range(vpp):        # 16-byte words, then the ends
                    if k < body:
                        covered += [head + 4 * k + e for e in range(4)]
                    elif k - body < ends:
                        i = k - body
                        covered.append(i if i < head else 4 * body + i)
                assert sorted(covered) == list(range(C))
                assert (sm + head) % 4 == 0


@pytest.mark.parametrize("re", [1, 2, 3])
def test_slice_padded_windows_stay_in_their_plane(re):
    """The padded (r, g) pass (blur_rg_pad): an item's window, read as
    4-byte pairs from the even column at or below g0 + SLICE_PAD - re, and
    its 2re + SLICE_RR source rows lie in the plane's padded rows and row
    pitch, and output (r0 + i, g0 + j) reads source (r0 + i - dr, g0 + j -
    dg) for every tap (the kernel's index arithmetic, mirrored)."""
    pad, rr_n, seg = CK.SLICE_PAD, CK.SLICE_RR, CK.STEP_SEG
    off = pad - re
    sh = off & 1
    win = seg + 2 * re
    npairs = (sh + win + 1) // 2
    for nc in SLICE_NC + (28,):
        ncp = CK.step_ncp(nc)
        prow = -(-nc // rr_n) * rr_n + 2 * pad
        pitch = ncp + 2 * pad
        assert (off - sh) % 2 == 0 and pitch % 2 == 0
        for g0 in range(0, ncp, seg):
            first = g0 + off - sh
            assert first >= 0 and first + 2 * npairs <= pitch
            for j in (0, seg - 1):
                for dg in (-re, re):
                    k = sh + j - dg + re          # the window's element
                    assert 0 <= k < 2 * npairs
                    assert first + k == g0 + j - dg + pad
        for r0 in range(0, nc, rr_n):
            rows = [r0 + rr_n - 1 + re - q + pad
                    for q in range(rr_n + 2 * re)]
            assert min(rows) >= 0 and max(rows) < prow
            for i in range(rr_n):
                for q in range(rr_n + 2 * re):
                    dr = i + q - (rr_n - 1) - re
                    if -re <= dr <= re:
                        assert rows[q] - pad == r0 + i - dr


def test_slice_plan_at_the_configs():
    """FAITHFUL_CONFIG's XLA engine at 512x512 (49 cells of 80x80, nc 21):
    the norm pass splits each cell's pixels two ways (98 blocks, one an
    SM); an iteration's 21 labels in 6 groups of 4, 294 blocks, 2 labels a
    blur round, each corner's labels one 8-byte load.  PRODUCTION_CONFIG
    (nc 15): the same groups.  Grids past the padded form's room (nc 29 and
    30, the largest the parent's grid blur took) take the compact form, one
    label a group."""
    p1 = CK.slice_plan(49, 6400, 1, 21)
    assert (p1.lg, p1.groups, p1.splits) == (1, 1, 2)
    p = CK.slice_plan(49, 6400, 21, 21)
    assert (p.lg, p.groups, p.lb, p.lgp, p.pad, p.splits) == (
        4, 6, 2, 4, True, 1)
    q = CK.slice_plan(49, 6400, 21, 15)
    assert (q.lg, q.groups, q.lb, q.lgp, q.pad) == (4, 6, 2, 4, True)
    for nc in (29, 30):
        big = CK.slice_plan(49, 6400, 21, nc)
        assert big.lg == 1 and not big.pad and big.smem <= LIMIT


def _pass_heights():
    """Cell heights of the plane engine: CellPlan's at sxy_bilateral 80
    (40-80 rows, test_blur_plan_fits_every_cell_height), 16 (sxy 16), 32
    (resolution_scale 2), and taller cells of larger sxy_bilateral up to
    256."""
    return sorted(set(range(40, 81)) | {16, 32, 96, 128, 160, 256})


PASS_HEIGHTS = _pass_heights()


@pytest.mark.parametrize("y_pass", [True, False])
@pytest.mark.parametrize("cs_x", [128, 40, 36])
def test_pass_plan_fits_and_covers_each_output_once(y_pass, cs_x):
    """Radii 17-128 (and the main path's 8) at every height that admits
    them: the tile fits and is the plan's; strips and label groups cover
    every row and label once; each thread round covers the items (y:
    column pairs by PASS_RY rows; x: 8 outputs of a row) once; every value
    an item reads lies in the staged tile, and output j reads tap k at the
    cell position j + k - r (the kernels' index arithmetic, mirrored)."""
    for n in [17] + list(range(35, 258, 2)):
        r = n // 2
        for cs_y in PASS_HEIGHTS:
            if r > min(cs_y, cs_x):
                continue
            for B, L in ((8, 21), (1, 3)):
                p = CK.pass_plan(B, 5, 4, cs_y, cs_x, L, n, y_pass)
                assert p.smem == CK.pass_smem(p.ty, cs_x, n, y_pass) <= LIMIT
                assert p.threads % 32 == 0
                assert 32 <= p.threads <= CK.PASS_MAX_THREADS
                rows = [y for s in range(p.strips) for y in
                        range(s * p.ty, s * p.ty + min(p.ty, cs_y - s * p.ty))]
                assert rows == list(range(cs_y))
                labels = [l for g in range(p.groups)
                          for l in range(g * p.lg, min(L, (g + 1) * p.lg))]
                assert labels == list(range(L))
                if p.strips > 1:
                    assert p.smem + 8 * cs_x > LIMIT or y_pass
            cx = -(-cs_x // 8) * 8
            if y_pass:
                ty = p.ty
                staged = -(-ty // CK.PASS_RY) * CK.PASS_RY + 2 * r
                segs = -(-ty // CK.PASS_RY)
                # item (cp, seg) reads tile rows seg*RY + m, m < RY + n - 1
                assert (segs - 1) * CK.PASS_RY + CK.PASS_RY + n - 2 < staged
                assert 2 * (-(-cs_x // 2)) <= cx
            else:
                halo = CK.pass_halo(n)
                assert r <= halo < r + 8 and halo % 8 == 0
                wp = cx + 2 * halo
                d = halo - r
                nw = (d + n + 6) // 8 + 1
                for x0 in range(0, cx, 8):
                    assert x0 + 8 * nw <= wp
                    for j in (0, 7):
                        for k in (0, n - 1):
                            t = x0 + d + j + k      # tile index read
                            assert 0 <= t < wp
                            assert t - halo == x0 + j + k - r


def test_pass_plan_at_voc_and_wide_gaussians():
    """The passes' geometry: whole 75-row VOC cells, labels in groups that
    give four blocks an SM (gn staged once a group); r = 20 at 512x512 in
    64x128 cells; r = 128 on 128x128 cells splits the y pass's tile into
    strips, the x pass's fits whole."""
    y = CK.pass_plan(8, 5, 4, 75, 128, 21, 17, True)
    x = CK.pass_plan(8, 5, 4, 75, 128, 21, 17, False)
    assert (y.ty, y.strips, x.ty, x.strips) == (75, 1, 75, 1)
    assert y.BZ * y.groups >= CK.PASS_SLOTS and y.lg > 1
    w = CK.pass_plan(8, 8, 4, 64, 128, 21, 41, True)
    assert (w.ty, w.strips) == (64, 1)
    big = CK.pass_plan(1, 4, 4, 128, 128, 21, 257, True)
    assert big.strips > 1 and big.ty == -(-128 // big.strips)
    assert CK.pass_plan(1, 4, 4, 128, 128, 21, 257, False).strips == 1


# ---------------------------------------------------------------------------
# The CRF's splat and mean-field step: launch plans, the splat's binning and
# the step's label-innermost scratch.

# Every cell geometry the CRF runs, as (Z, P of the splat, P of the step):
# production 512x512 (64x128 cells, stride 2) at B=8 and B=1; VOC 375x500
# (75x128, stride 1) and 500x375 (50x128, stride 2) at B=8; resolution_scale
# 2 at 512x512 (32x40 cells, stride 2); sxy_bilateral=16 (16x16 cells,
# Z = 1024 an image); the XLA engine's 80x80 cells at stride 1 and 2.
CRF_GEOMETRIES = [(256, 2048, 8192), (32, 2048, 8192), (160, 9600, 9600),
                  (240, 1600, 6400), (416, 320, 1280), (1024, 256, 256),
                  (49, 6400, 6400), (49, 1600, 6400)]
CRF_LABELS = (1, 2, 5, 21)
CRF_NC = (9, 13, 15, 21)


def test_crf_geometries_are_the_plans():
    """The table above is what CellPlan and BilateralPlan give."""
    prod = CRF.PRODUCTION_CONFIG
    for (h, w), cfg, want in (
            ((512, 512), prod, (64, 128, 2)), ((375, 500), prod, (75, 128, 1)),
            ((500, 375), prod, (50, 128, 2)),
            ((512, 512), CRF.CrfConfig(sxy_bilateral=16.0), (16, 16, 1))):
        p = DC.CellPlan(8, h, w, cfg.sxy_bilateral, cfg.srgb,
                        cfg.color_step, cfg.splat_stride)
        assert (p.cs_y, p.cs_x, p.stride) == want
        assert (p.P // p.stride ** 2, p.P) in {g[1:] for g in CRF_GEOMETRIES}
    nc = {DC.CellPlan(1, 512, 512, c.sxy_bilateral, c.srgb, c.color_step).nc
          for c in (CRF.FAITHFUL_CONFIG, CRF.FAST_FAITHFUL_CONFIG, prod,
                    CRF.THROUGHPUT_CONFIG)}
    assert nc == set(CRF_NC)


@pytest.mark.parametrize("nc", CRF_NC)
@pytest.mark.parametrize("L", CRF_LABELS)
@pytest.mark.parametrize("geom", CRF_GEOMETRIES)
def test_splat_plan_fits_and_covers_each_pixel_and_label_once(geom, L, nc):
    Z, P, _ = geom
    p = CK.splat_plan(Z, P, L, nc)
    assert p.smem == CK.splat_smem(nc, p.lg, p.pc) <= LIMIT
    assert p.grid == (Z, p.groups) and p.groups <= 65535
    # chunks of pc pixels (the kernel's c0 loop), each within the threads'
    # SPLAT_MAX_PPT pixels a thread
    pixels = [c0 + i for c0 in range(0, P, p.pc)
              for i in range(min(p.pc, P - c0))]
    assert pixels == list(range(P))
    assert p.pc % 4 == 0 and p.pc <= CK.SPLAT_MAX_PPT * CK.SPLAT_THREADS
    # label groups l0 = g*lg, min(lg, L - l0) labels each
    labels = [g * p.lg + i for g in range(p.groups)
              for i in range(min(p.lg, L - g * p.lg))]
    assert labels == list(range(L))
    # pieces (first | len << 16) and the scan's packed counts fit 16 bits
    assert 1 <= p.k <= p.pc < 1 << 16


def test_splat_plan_at_production():
    """B=8: two groups of 11 and 10 labels, chunks of 1024 pixels, one
    block an SM; the norm pass one chunk of the cell's 2048; B=1: more
    groups, so that the blocks still fill the card."""
    p = CK.splat_plan(256, 2048, 21, 15)
    assert (p.lg, p.groups, p.pc) == (11, 2, 1024)
    assert 2 * (p.smem + 1024) > 233472
    assert (CK.splat_plan(256, 2048, 1, 15).pc,
            CK.splat_plan(256, 2048, 1, 15).groups) == (2048, 1)
    p1 = CK.splat_plan(32, 2048, 21, 15)
    assert p1.groups * 32 >= CK.SPLAT_SLOTS


@pytest.mark.parametrize("nc", CRF_NC)
@pytest.mark.parametrize("L", list(range(1, 41)))
def test_step_plan_sends_exactly_the_grids_that_do_not_fit(L, nc):
    C = nc * nc
    ncp = -(-nc // 8) * 8
    grid = -(-2 * (nc * L * C + 8) // 16) * 16
    fits = L <= CK.STEP_LMAX and grid + 4 * nc * nc * ncp <= LIMIT
    p = CK.step_plan(256, 8192, nc, L)
    assert p.fused == fits == CK.step_fits(nc, L)
    if p.fused:
        assert p.smem == CK.step_fused_smem(nc, L, p.lb) <= LIMIT
        # blur rounds of lb labels cover every label once
        labels = [l0 + i for l0 in range(0, L, p.lb)
                  for i in range(min(p.lb, L - l0))]
        assert labels == list(range(L))
    else:
        assert p.smem == CK.step_blur_smem(nc) <= LIMIT
        assert p.lp >= L and p.lp % 4 == 0 and p.lp - L < 4
        # the pixel pass's logits: registers, or L x 256 f32 in shared memory
        assert L <= CK.STEP_LMAX or 4 * L * 256 <= LIMIT


@pytest.mark.parametrize("nc", CRF_NC)
@pytest.mark.parametrize("L", CRF_LABELS)
@pytest.mark.parametrize("geom", CRF_GEOMETRIES)
def test_step_plan_splits_cover_each_pixel_once(geom, L, nc):
    """Block (z, s) of the fused kernel takes the pixel chunks s, s +
    splits, ... of step_threads(L) pixels: together every pixel once; a
    cell takes several blocks only where the cells are fewer than the
    card's STEP_SLOTS, and never more blocks than it has chunks."""
    Z, _, P = geom
    p = CK.step_plan(Z, P, nc, L)
    if not p.fused:
        return
    T = CK.step_threads(L)
    assert T == (1024 if L == 21 else 512)
    pixels = sorted(c0 + i for s in range(p.splits)
                    for c0 in range(s * T, P, T * p.splits)
                    for i in range(min(T, P - c0)))
    assert pixels == list(range(P))
    chunks = -(-P // T)
    assert 1 <= p.splits <= max(1, chunks)
    if Z >= CK.STEP_SLOTS:
        assert p.splits == 1
    else:
        assert Z * p.splits >= min(CK.STEP_SLOTS, Z * chunks)


def test_step_plan_at_the_configs():
    """nc 15 with 21 labels (production, B=8) fuses: one block a cell, 6
    labels a blur round; at B=1 five blocks a cell; nc 21 with 21 labels
    (faithful, a 389 KB grid) takes two kernels."""
    p = CK.step_plan(256, 8192, 15, 21)
    assert (p.fused, p.lb, p.splits) == (True, 6, 1)
    assert p.smem <= LIMIT and 15 * 21 * 225 * 2 == 141750
    assert CK.step_plan(32, 8192, 15, 21).splits == 5
    assert not CK.step_plan(256, 8192, 21, 21).fused
    assert 21 * 21 * 441 * 2 > LIMIT
    two = CK.two_kernel_step_plan(15, 21)
    assert not two.fused and two.lp == 24


def _hat_np(c):
    """The kernels' hat(): base bin floor(c) and the weights of it and the
    next bin, in f32."""
    c = c.astype(np.float32)
    f = np.floor(c)
    one = np.float32(1)
    w0 = np.maximum(one - np.abs(f - c), 0).astype(np.float32)
    w1 = np.maximum(one - np.abs((f + one) - c), 0).astype(np.float32)
    return f.astype(np.int64), w0, w1


def _bf_np(x):
    return CK._bf(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _splat_model(rgb, values, nc, inv_step, k):
    """The splat kernel's arithmetic in numpy, one cell (rows, P) and its
    values (L, P): keys, a counting sort into pieces of at most k, per
    (piece, label) the 8 corner sums in sorted order, then one add a corner.
    Returns (grid (nc*L, nc^2) f32, order, pieces, keys)."""
    nk = nc + 1
    L, P = values.shape
    coords = (rgb[:3] * np.float32(inv_step)).astype(np.float32)
    ok = np.all((coords >= -1) & (coords < nc), axis=0)
    (ir, wr0, wr1), (ig, wg0, wg1), (ib, wb0, wb1) = (
        _hat_np(coords[i]) for i in range(3))
    keys = np.where(ok, ((ib + 1) * nk + ir + 1) * nk + ig + 1, -1)
    # counting sort: a histogram, its exclusive scan, a scatter
    hist = np.bincount(keys[ok], minlength=nk ** 3)
    start = np.concatenate([[0], np.cumsum(hist)[:-1]])
    order = np.empty(int(ok.sum()), np.int64)
    fill = start.copy()
    for p in np.nonzero(ok)[0]:
        order[fill[keys[p]]] = p
        fill[keys[p]] += 1
    pieces = [(key, int(start[key]) + i, int(min(k, hist[key] - i)))
              for key in np.nonzero(hist)[0] for i in range(0, hist[key], k)]
    scale = rgb[CK.ATTR_BSCALE] if rgb.shape[0] == CK.ATTR_ROWS else 1.0
    vb = _bf_np(values * np.float32(1) * scale)                  # (L, P)
    wrg = [_bf_np(a * b) for a in (wr0, wr1) for b in (wg0, wg1)]
    wb = [_bf_np(wb0), _bf_np(wb1)]
    grid = np.zeros((nc, L, nc * nc), np.float32)
    firsts = np.array([f for _, f, _ in pieces], np.int64)
    for kb in range(2):
        t = _bf_np(vb * wb[kb])                                  # (L, P)
        for j in range(4):
            terms = (t * wrg[j])[:, order].astype(np.float32)   # exact
            sums = np.add.reduceat(terms, firsts, axis=1)       # per piece
            for n, (key, _, _) in enumerate(pieces):
                b = key // (nk * nk) - 1 + kb
                r = (key // nk) % nk - 1 + j // 2
                g = key % nk - 1 + j % 2
                if 0 <= b < nc and 0 <= r < nc and 0 <= g < nc:
                    grid[b, :, r * nc + g] += sums[:, n]
    return grid.reshape(nc * L, nc * nc), order, pieces, keys


def _cells(kind, Z, P, seed):
    """Packed attrs planes (Z, 8, P) of seeded 32x64 cells: one color,
    uniform noise, or the committed CRF scenes."""
    rs = np.random.RandomState(seed)
    if kind == "flat":
        rgb = np.full((Z, 3, P), 131.0, np.float32)
    elif kind == "noise":
        rgb = rs.uniform(0, 255, (Z, 3, P)).astype(np.float32)
    else:
        from crf_scenes import make_scene
        im, _ = make_scene(64, 128, 5, seed)
        rgb = np.stack([im[32 * (z // 2):32 * (z // 2) + 32,
                           64 * (z % 2):64 * (z % 2) + 64].reshape(P, 3).T
                        for z in range(Z)]).astype(np.float32)
    attrs = np.zeros((Z, CK.ATTR_ROWS, P), np.float32)
    attrs[:, :3] = rgb
    attrs[:, CK.ATTR_BSCALE] = rs.uniform(0.5, 4.0, (Z, P))
    return attrs


@pytest.mark.parametrize("kind", ["flat", "noise", "structured"])
def test_splat_binning_model_matches_the_plain_version(kind):
    Z, P, L, nc = 2, 2048, 3, 15
    inv_step = 1.0 / 19.5
    k = CK.splat_plan(Z, P, L, nc).k
    attrs = _cells(kind, Z, P, 11)
    rs = np.random.RandomState(12)
    q = _bf_np(rs.rand(Z, L, P))
    valid = np.ones((Z, 1, P), np.float32)
    for rows, vals, dtype in ((attrs[:, :3], valid, torch.float32),
                              (attrs, q, torch.bfloat16)):
        want = CK.splat_planes_reference(
            torch.from_numpy(np.ascontiguousarray(rows)),
            torch.from_numpy(vals).to(dtype), nc=nc, L=vals.shape[1],
            inv_step=inv_step, out_dtype=dtype).float().numpy()
        for z in range(Z):
            grid, order, pieces, keys = _splat_model(
                rows[z], vals[z], nc, inv_step, k)
            # every pixel in exactly one piece; no piece mixes keys or
            # passes k pixels
            covered = np.concatenate([order[f:f + n] for _, f, n in pieces])
            assert sorted(covered) == list(range(P))
            for key, f, n in pieces:
                assert 1 <= n <= k and set(keys[order[f:f + n]]) == {key}
            if kind == "flat":
                assert len(pieces) == P // k
            if dtype == torch.bfloat16:
                grid = _bf_np(grid)
                rel = CK.PLAIN_BF16_REL
            else:
                rel = CK.PLAIN_F32_REL
            err = np.abs(grid - want[z]).max()
            assert err <= rel * np.abs(want[z]).max(), (kind, z, err)


def test_step_scratch_index_map_round_trips():
    """The two-kernel form's blurred grid lies in chunks of 4 labels, each
    label-innermost, [chunk][b][r][g][4]: element (d = b*L + l, c) of the
    (D, C) grid lives at ((l // 4) * nc^3 + b*C + c) * 4 + l % 4, and a
    pixel's corner offsets (the source's corners(): b*bstride + (r*nc +
    g)*cstride, here 4*C and 4) address the same values in both layouts,
    label l adding l*C in one and its chunk's nc^3 * 4 plus l % 4 in the
    other."""
    nc, L = 15, 21
    C, lp = nc * nc, CK.two_kernel_step_plan(nc, L).lp
    n3 = nc * C
    grid = np.random.RandomState(3).rand(nc * L, C).astype(np.float32)
    scratch = np.full(n3 * lp, np.nan, np.float32)
    b, l, c = np.meshgrid(np.arange(nc), np.arange(L), np.arange(C),
                          indexing="ij")
    idx = ((l // 4) * n3 + b * C + c) * 4 + l % 4
    assert len(np.unique(idx)) == idx.size and idx.max() < scratch.size
    scratch[idx] = grid[b * L + l, c]
    # the inverse map recovers (b, l, c)
    chunk, rest = idx // (4 * n3), idx % (4 * n3)
    assert (chunk * 4 + rest % 4 == l).all()
    assert (rest // 4 // C == b).all() and (rest // 4 % C == c).all()
    back = np.empty_like(grid)
    back[b * L + l, c] = scratch[idx]
    assert np.array_equal(back, grid)
    for cb, cr, cg in itertools.product(range(nc), repeat=3):
        dc_off = cb * L * C + cr * nc + cg
        li_off = cb * C * 4 + (cr * nc + cg) * 4
        for lab in (0, 3, 4, 7, 8, L - 1):
            assert (scratch[(lab // 4) * n3 * 4 + li_off + lab % 4]
                    == grid.reshape(-1)[dc_off + lab * C])


# ---------------------------------------------------------------------------
# The training block's halo phases F2 and B34 (csrc/fused_mbconv_train.cu)
# and B34's dW1^T kernel: launch plans (kernels/fused_mbconv_train.py::
# train_plan).

# tests/test_torch_kernels_gpu.py's training shapes: (rate, Cin, Ce, H, W)
# at B=2, ragged maps included
TRAIN_GPU_SHAPES = [(1, 24, 144, 20, 36), (2, 32, 200, 16, 13),
                    (4, 16, 96, 8, 8), (4, 160, 960, 16, 16),
                    (2, 32, 192, 24, 24), (4, 160, 960, 19, 35),
                    (2, 96, 576, 37, 21), (1, 24, 144, 26, 7)]


def _train_cases():
    for B in (2, 16):
        for cin, ce, cout, rate, hw in MAIN:
            yield B, hw, hw, cin, ce, cout, rate
    for rate, cin, ce, H, W in TRAIN_GPU_SHAPES:
        yield 2, H, W, cin, ce, 8, rate
    for cin, ce, cout, rate, _ in MAIN:
        for H, W in ((37, 21), (26, 7)):
            yield 2, H, W, cin, ce, cout, rate


@pytest.mark.parametrize("phase", ["f2", "b34"])
@pytest.mark.parametrize("case", list(_train_cases()))
def test_train_plan_fits_and_is_instantiated(case, phase):
    B, H, W, cin, ce, cout, rate = case
    p = FMT.train_plan(phase, B, H, W, cin, ce, cout, rate)
    assert p.smem <= LIMIT
    assert p.smem == FMT.train_smem(phase, H, W, cin, rate, p.th, p.tw, p.ck,
                                    p.stages)
    assert (p.th, p.tw) in FMT.TRAIN_TILES and p.ck in FMT.TRAIN_CHUNKS
    assert p.stages in (2, 3) and p.warps == FMT.TRAIN_WARPS
    assert p.grid == (p.tiles_y * p.tiles_x, B) and B <= 65535
    # the tap table's 16-bit word offsets reach the zero row
    rows = FMT._box_rows(H, W, p.th, p.tw, rate)
    assert (rows + 1) * (p.ck // 2) <= 32767
    if phase == "b34":
        assert p.nt in FMT.WG_NT and 2 * p.nt * 8 >= cin
        assert 1 <= p.splits <= -(-B * H * W // FMT.WG_GP)
        assert FMT.wg_smem(cin) <= LIMIT and FMT.dx_smem(cin) <= LIMIT
    else:
        assert p.nt == p.splits == 0


def _train_coverage(H, W, th, tw, rate, ck, phase):
    """The halo kernels' tile, box, tap-table, box-row-table and taps
    arithmetic (csrc/fused_mbconv_train.cu), mirrored: the count of each
    output pixel, the largest box, and for one tile the count of each
    (tile pixel, channel) the taps visit."""
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    twl = {8: 3, 16: 4}[tw]
    rows = FMT._box_rows(H, W, th, tw, rate)
    seen, nv_max = {}, 0
    for blk in range(tiles_x * tiles_y):
        ty0, tx0 = (blk // tiles_x) * th, (blk % tiles_x) * tw
        sy0, sx0 = max(ty0 - rate, 0), max(tx0 - rate, 0)
        sy1, sx1 = min(ty0 + th + rate, H), min(tx0 + tw + rate, W)
        hx = sx1 - sx0
        nv = (sy1 - sy0) * hx
        nv_max = max(nv_max, nv)
        ctab = {}
        for hp in range(rows):
            if hp < nv:
                py, px = sy0 + hp // hx - ty0, sx0 + hp % hx - tx0
                if 0 <= py < th and 0 <= px < tw:
                    ctab[hp] = py * tw + px
        for p in range(th * tw):
            gy, gx = ty0 + (p >> twl), tx0 + (p & (tw - 1))
            inside = gy < H and gx < W
            for tap in range(9):
                yy, xx = gy + (tap // 3 - 1) * rate, gx + (tap % 3 - 1) * rate
                ok = inside and 0 <= yy < H and 0 <= xx < W
                R = (yy - sy0) * hx + xx - sx0 if ok else rows
                if ok:  # a tap in the image lies in the box, at its pixel
                    assert 0 <= R < nv and R < rows
                    assert (sy0 + R // hx, sx0 + R % hx) == (yy, xx)
                if tap == 4:  # the centre tap says whether the pixel counts
                    assert (R != rows) == inside
                    if inside:
                        assert ctab[R] == p
            if inside:
                seen[gy, gx] = seen.get((gy, gx), 0) + 1
        # each pixel of the tile that lies in the image has one box row
        assert sorted(ctab.values()) == sorted(
            p for p in range(th * tw)
            if ty0 + (p >> twl) < H and tx0 + (p & (tw - 1)) < W)
    # the taps: F2 four channels a thread, B34 two
    per = 4 if phase == "f2" else 2
    cl, warps = ck // per, FMT.TRAIN_WARPS
    sub, tp = 32 // cl, th * tw
    step = warps * sub
    taps = {}
    for warp in range(warps):
        for lane in range(32):
            for k in range(-(-tp // step)):
                p = warp * sub + lane // cl + k * step
                if p >= tp:
                    break
                for c in range(per * (lane % cl), per * (lane % cl) + per):
                    taps[p, c] = taps.get((p, c), 0) + 1
    return seen, nv_max, rows, taps


@pytest.mark.parametrize("phase", ["f2", "b34"])
@pytest.mark.parametrize("case", [
    (16, 64, 64, 160, 960, 160, 4), (16, 64, 64, 160, 960, 320, 4),
    (16, 64, 64, 64, 384, 64, 2), (16, 128, 128, 24, 144, 24, 1),
    (2, 37, 21, 96, 576, 160, 2), (2, 26, 7, 32, 192, 64, 1),
    (2, 19, 35, 160, 960, 160, 4), (2, 8, 8, 16, 96, 16, 4),
    (2, 20, 36, 24, 144, 24, 1), (2, 16, 13, 32, 200, 64, 2)])
def test_train_tiles_cover_every_output_once(case, phase):
    """Each tile and chunk the kernels may be given (where it fits), at the
    net's maps and ragged ones."""
    B, H, W, cin, ce, cout, rate = case
    for tile in FMT.TRAIN_TILES:
        for ck in FMT.TRAIN_CHUNKS:
            if FMT.train_smem(phase, H, W, cin, rate, *tile, ck, 2) > LIMIT:
                continue
            seen, nv_max, rows, taps = _train_coverage(H, W, *tile, rate, ck,
                                                       phase)
            assert len(seen) == H * W and set(seen.values()) == {1}
            assert -(-nv_max // 16) * 16 <= rows
            assert len(taps) == tile[0] * tile[1] * ck
            assert set(taps.values()) == {1}


@pytest.mark.parametrize("P,cin", [(2 * 64 * 64, 160), (2 * 37 * 21, 96),
                                   (2 * 26 * 7, 24), (16 * 64 * 64, 64)])
def test_train_dx_warps_cover_each_output_once(P, cin):
    """dx's blocks (128 pixels), warps (two pixel m-tiles and one half of
    Cin each) and stored n-tiles cover each (pixel, input channel) of dx
    once; the pairs of n-tiles they load lie in w1's rows padded to 16."""
    nt, cin_p = FMT.train_plan("b34", 2, 64, 64, cin, 6 * cin, 8, 1).nt, \
        -(-cin // 16) * 16
    got = {}
    for blk in range(-(-P // FMT.DX_M)):
        for warp in range(FMT.DX_WARPS):
            wm, wn = warp & 3, warp >> 2
            for j in range(0, nt, 2):
                if (wn * nt + j) * 8 >= cin_p:   # the kernel skips the pair
                    continue
                assert (wn * nt + j + 2) * 8 <= cin_p
                for jj in (j, j + 1):
                    for m in range(2):
                        for r in range(16):
                            p = blk * FMT.DX_M + wm * 32 + m * 16 + r
                            for n in range((wn * nt + jj) * 8,
                                           (wn * nt + jj) * 8 + 8):
                                if p < P and n < cin:
                                    got[p, n] = got.get((p, n), 0) + 1
    assert len(got) == P * cin and set(got.values()) == {1}


@pytest.mark.parametrize("cin,ce", [(24, 144), (32, 192), (64, 384),
                                    (96, 576), (160, 960), (16, 96),
                                    (32, 200)])
def test_train_weight_gradient_warps_cover_each_entry_once(cin, ce):
    """dW1^T's blocks (128 channels of Ce), warps (two channel m-tiles and
    one half of Cin each) and stored n-tiles cover each (channel, input
    channel) of the (Ce, Cin) gradient once; its pixel splits each group of
    64 pixels once."""
    p = FMT.train_plan("b34", 2, 64, 64, cin, ce, 8, 2)
    nt, cin_p = p.nt, -(-cin // 16) * 16
    got = {}
    for blk in range(-(-ce // FMT.WG_M)):
        for warp in range(FMT.WG_WARPS):
            wm, wn = warp & 3, warp >> 2
            for j in range(0, nt, 2):
                if (wn * nt + j) * 8 >= cin_p:   # the kernel skips the pair
                    continue
                for jj in (j, j + 1):
                    for m in range(2):
                        for r in range(16):
                            row = blk * FMT.WG_M + wm * 32 + m * 16 + r
                            for n in range((wn * nt + jj) * 8,
                                           (wn * nt + jj) * 8 + 8):
                                if row < ce and n < cin:
                                    got[row, n] = got.get((row, n), 0) + 1
    assert len(got) == ce * cin and set(got.values()) == {1}
    groups = -(-2 * 64 * 64 // FMT.WG_GP)
    mine = [g for s in range(p.splits)
            for g in range(s, groups, p.splits)]
    assert sorted(mine) == list(range(groups))


@pytest.mark.parametrize("tile,rate,factor", [
    ((16, 16), 1, 1.25), ((16, 16), 2, 1.44), ((16, 16), 4, 1.89),
    ((8, 16), 4, 2.58)])
def test_train_halo_factor_stated_in_the_header(tile, rate, factor):
    """csrc/fused_mbconv_train.cu states these for a 64x64 map, beside the
    full boxes of fixed 8x8 tiles that the design replaced."""
    got = FMT.train_halo(64, 64, *tile, rate)
    assert abs(got - factor) <= 0.005
    with open(FMT.__file__.replace("fused_mbconv_train.py",
                                   "csrc/fused_mbconv_train.cu")) as f:
        header = f.read().split("#include")[0]
    assert f"{factor:.2f}x" in header
    for r, old in ((1, 1.56), (2, 2.25), (4, 4.00)):
        assert f"{old:.2f}x" in header
        assert round((8 + 2 * r) ** 2 / 64, 2) == old


def test_train_main_path_plans_at_the_training_batch():
    """At B=16 the rate-4 blocks expand at most 2.58 pixels per output pixel
    in both phases (the fixed 8x8 tiles over full boxes: 4.00), and every
    block shape at most the old tiles' full box."""
    for cin, ce, cout, rate, hw in MAIN:
        for phase in ("f2", "b34"):
            p = FMT.train_plan(phase, 16, hw, hw, cin, ce, cout, rate)
            assert p.halo <= (8 + 2 * rate) ** 2 / 64
            if rate == 4:
                assert p.halo <= 2.58 + 0.005, (phase, p)


# ---------------------------------------------------------------------------
# fused_sepconv (kernels/fused_mbconv.py::sepconv_plan)

# The stride-1 SepConv_BN launches of the 512x512 Xception net: (Cin, Cout,
# rate, map side) -> launches per forward, at output stride 16 and 8
# (test_sepconv_shapes_are_the_nets_own records them from the net).
XCEPTION_SHAPES = {
    16: {(64, 128, 1, 256): 1, (128, 128, 1, 256): 1, (128, 256, 1, 128): 1,
         (256, 256, 1, 128): 2, (256, 728, 1, 64): 1, (728, 728, 1, 64): 1,
         (728, 728, 1, 32): 49, (728, 1024, 1, 32): 1,
         (1024, 1024, 1, 32): 1, (1024, 1536, 2, 32): 1,
         (1536, 1536, 2, 32): 1, (1536, 2048, 2, 32): 1,
         (2048, 256, 6, 32): 1, (2048, 256, 12, 32): 1,
         (2048, 256, 18, 32): 1, (304, 256, 1, 128): 1},
    8: {(64, 128, 1, 256): 1, (128, 128, 1, 256): 1, (128, 256, 1, 128): 1,
        (256, 256, 1, 128): 2, (256, 728, 1, 64): 1, (728, 728, 1, 64): 2,
        (728, 728, 2, 64): 49, (728, 1024, 2, 64): 1,
        (1024, 1024, 2, 64): 1, (1024, 1536, 4, 64): 1,
        (1536, 1536, 4, 64): 1, (1536, 2048, 4, 64): 1,
        (2048, 256, 12, 64): 1, (2048, 256, 24, 64): 1,
        (2048, 256, 36, 64): 1, (304, 256, 1, 128): 1}}
# tests/test_torch_kernels_gpu.py's fused_sepconv shapes: (Cin, Cout, rate,
# H, W) at B=1 or 2
SEPCONV_GPU_SHAPES = [(728, 728, 1, 16, 16), (1536, 2048, 2, 12, 12),
                      (2048, 256, 18, 32, 32), (304, 256, 1, 128, 128),
                      (728, 728, 1, 37, 21), (2048, 256, 36, 37, 21),
                      (256, 728, 1, 26, 7), (16, 24, 1, 8, 8),
                      (1536, 1536, 40, 19, 35)]


def test_sepconv_shapes_are_the_nets_own():
    """The table above is what the Xception net gives the kernel: its
    calls recorded on a 64x64 input (maps 8x smaller, same rates)."""
    from deeplab_tpu_torch import SegNet
    for OS, want in XCEPTION_SHAPES.items():
        net = SegNet((64, 64), 21, backbone="xception", OS=OS).eval()
        got = {}
        kernel = FM.fused_sepconv

        def record(x, *w, **kw):
            key = (x.shape[3], w[2].shape[1], kw["rate"], 8 * x.shape[1])
            assert x.shape[1] == x.shape[2]
            got[key] = got.get(key, 0) + 1
            return FM.fused_sepconv_reference(x, *w, **kw)
        FM.fused_sepconv = record
        try:
            with torch.no_grad():
                net.logits(torch.rand(1, 64, 64, 3) * 255, "mixed")
        finally:
            FM.fused_sepconv = kernel
        assert got == want, OS
        assert sum(want.values()) == {16: 65, 8: 66}[OS]


def _sepconv_cases():
    for OS, shapes in XCEPTION_SHAPES.items():
        for cin, cout, rate, hw in shapes:
            for B in (2, 8, 16):
                yield B, hw, hw, cin, cout, rate
            for H, W in ((37, 21), (26, 7)):
                yield 2, H, W, cin, cout, rate
    for cin, cout, rate, H, W in SEPCONV_GPU_SHAPES:
        yield 2, H, W, cin, cout, rate


def _sepconv_instantiations():
    with open(FM.__file__.replace("fused_mbconv.py",
                                  "csrc/fused_sepconv.cu")) as f:
        src = f.read()
    import re
    return {tuple(int(v) for v in m) for m in
            re.findall(r"SEP_CASE\((\d+), (\d+)\)", src)}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", sorted(set(_sepconv_cases())))
def test_sepconv_plan_fits_and_is_instantiated(case, bf16):
    B, H, W, cin, cout, rate = case
    p = FM.sepconv_plan(B, H, W, cin, cout, rate, bf16)
    esz = 2 if bf16 else 4
    assert p.smem <= LIMIT
    assert p.smem == FM.sepconv_smem(H, W, cin, cout, rate, p.th, p.tw, p.ck,
                                     p.stages, p.nt, p.cg, esz)
    assert p.th == p.tw == FM.SEPCONV_TILE and p.ck in FM.SEPCONV_CHUNKS
    assert p.nt in FM.SEPCONV_NT and p.stages in (2, 3)
    assert (p.ck, p.nt) in _sepconv_instantiations()
    assert _sepconv_instantiations() == {(c, n) for c in FM.SEPCONV_CHUNKS
                                         for n in FM.SEPCONV_NT}
    assert p.np_ == FM.sepconv_np(p.nt)
    # the groups split Cout into whole n-tiles, none of them empty
    assert p.cg % 8 == 0 and p.groups * p.cg >= cout
    assert (p.groups - 1) * p.cg < cout
    # A holds all of Cin exactly where a block takes more than one pass
    n_chunks = -(-cin // p.ck)
    assert p.a_slots == (n_chunks if p.passes > 1 else 2)
    assert p.grid == (p.tiles_y * p.tiles_x * p.groups, B)
    assert p.grid[0] < 2 ** 31 and B <= 65535


def _sepconv_coverage(B, H, W, cin, cout, rate, p):
    """csrc/fused_sepconv.cu's index arithmetic, mirrored: the tiles, the
    box of each (bands, tap table, box pixels), the depthwise threads, the
    wpw slices' swizzled copies, and the groups, passes, warps and n-tiles
    of the pointwise.  Returns the count of each output pixel and of each
    (tile pixel, output channel)."""
    M, NP = p.th * p.tw, p.np_
    rows = FM.sepconv_box(H, W, p.th, p.tw, rate)
    seen = {}
    for tile in range(p.tiles_y * p.tiles_x):
        ty0, tx0 = (tile // p.tiles_x) * p.th, (tile % p.tiles_x) * p.tw
        by = FM._sep_bands(H, ty0, p.th, rate)
        bx = FM._sep_bands(W, tx0, p.tw, rate)
        ny, nx = sum(n for _, n in by), sum(n for _, n in bx)
        assert ny * nx <= rows

        def pos(bands, v):
            off = 0
            for lo, n in bands:
                if lo <= v < lo + n:
                    return off + v - lo
                off += n
            return -1

        def at(bands, i):
            for lo, n in bands:
                if i < n:
                    return lo + i
                i -= n
            raise AssertionError("past the bands")
        for pix in range(M):
            py, px = ty0 + pix // p.tw, tx0 + pix % p.tw
            if py >= H or px >= W:
                continue
            seen[py, px] = seen.get((py, px), 0) + 1
            for q in range(9):
                yy, xx = py + (q // 3 - 1) * rate, px + (q % 3 - 1) * rate
                if 0 <= yy < H and 0 <= xx < W:
                    iy, ix = pos(by, yy), pos(bx, xx)
                    assert iy >= 0 and ix >= 0
                    row = iy * nx + ix
                    assert row < rows
                    assert (at(by, row // nx), at(bx, row % nx)) == (yy, xx)
    # the depthwise: each (tile pixel, channel quad) of a chunk once
    cq = p.ck // 4
    threads = 32 * FM.SEPCONV_WARPS
    pstep = threads // cq
    dw = {}
    for tid in range(threads):
        for jp in range(-(-M // pstep)):
            pix = tid // cq + jp * pstep
            if pix >= M:
                break
            dw[pix, tid % cq] = dw.get((pix, tid % cq), 0) + 1
    assert len(dw) == M * cq and set(dw.values()) == {1}
    # the pointwise: groups, passes, then each warp's staging rounds (warp
    # w of warpgroup w // 4: rows 16 (w % 4) .. + 16, columns of its
    # warpgroup's N = 16 NT, NT n-tiles a round), stored below the pass
    # width
    acc = {}
    for grp in range(p.groups):
        n_lo = grp * p.cg
        n_hi = min(n_lo + p.cg, cout)
        for ps in range(-(-(n_hi - n_lo) // NP)):
            n0 = n_lo + ps * NP
            w = min(NP, n_hi - n0)
            for warp in range(FM.SEPCONV_WARPS):
                for m in range(2):
                    r_lo = (warp & 3) * 16
                    c_lo = (warp >> 2) * 16 * p.nt + m * 8 * p.nt
                    for j in range(p.nt):
                        if c_lo + j * 8 >= w:
                            continue
                        for r in range(16):
                            for c in range(8):
                                key = (r_lo + r, n0 + c_lo + j * 8 + c)
                                acc[key] = acc.get(key, 0) + 1
    assert 2 * 16 * p.nt == NP and 4 * 16 == M
    return seen, acc


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", [
    (8, 32, 32, 728, 728, 1), (8, 32, 32, 1536, 2048, 2),
    (8, 32, 32, 2048, 256, 18), (8, 64, 64, 2048, 256, 36),
    (8, 128, 128, 304, 256, 1), (8, 256, 256, 64, 128, 1),
    (2, 37, 21, 728, 728, 2), (2, 37, 21, 2048, 256, 12),
    (2, 26, 7, 1024, 1536, 4), (2, 19, 35, 1536, 1536, 40),
    (2, 8, 8, 16, 24, 1)])
def test_sepconv_tiles_cover_every_output_once(case, bf16):
    """Every output pixel and channel once, at the net's shapes, ragged
    maps and rates past the map; and each forced chunk and pass
    width that fits."""
    B, H, W, cin, cout, rate = case
    plans = [FM.sepconv_plan(B, H, W, cin, cout, rate, bf16)]
    tile = (FM.SEPCONV_TILE, FM.SEPCONV_TILE)
    for ck in FM.SEPCONV_CHUNKS:
        for nt in FM.SEPCONV_NT:
            cg = -(-cout // 8) * 8
            smem = FM.sepconv_smem(H, W, cin, cout, rate, *tile, ck, 2, nt,
                                   cg, 2 if bf16 else 4)
            if smem <= LIMIT:
                plans.append(FM.SepconvPlan(
                    *tile, ck, 2, nt, 1, cg, FM.sepconv_np(nt), 0, smem,
                    -(-H // tile[0]), -(-W // tile[1]), B, 0.0, 0.0))
    for p in plans:
        seen, acc = _sepconv_coverage(B, H, W, cin, cout, rate, p)
        assert len(seen) == H * W and set(seen.values()) == {1}
        assert len(acc) == p.th * p.tw * cout and set(acc.values()) == {1}


@pytest.mark.parametrize("side", [32, 64, 37])
def test_sepconv_box_does_not_grow_with_the_rate(side):
    """The staged box stays within 3TH x 3TW at every rate, however large
    against the map; at rates past the map it is the tile itself."""
    th = tw = FM.SEPCONV_TILE
    for rate in range(1, 3 * side):
        box = FM.sepconv_box(side, side, th, tw, rate)
        assert box <= 9 * th * tw, rate
        if rate >= side:
            assert box == th * tw


@pytest.mark.parametrize("tile,rate,factor", [
    ((8, 8), 1, 1.41), ((8, 8), 2, 1.89),
    ((8, 8), 6, 4.52), ((8, 8), 12, 5.06), ((8, 8), 18, 3.52)])
def test_sepconv_halo_factor_stated_in_the_header(tile, rate, factor):
    """csrc/fused_sepconv.cu states these for a 32x32 map, beside the
    whole map's 16.00x; a brute count of each tile's box reproduces the
    plan's."""
    got = FM.sepconv_halo(32, 32, *tile, rate)
    assert abs(got - factor) <= 0.005
    total = 0
    for ty0 in range(0, 32, tile[0]):
        for tx0 in range(0, 32, tile[1]):
            ys = {ty0 + py + (i - 1) * rate for py in range(tile[0])
                  for i in range(3)}
            xs = {tx0 + px + (j - 1) * rate for px in range(tile[1])
                  for j in range(3)}
            ys = {y for y in ys if 0 <= y < 32}
            xs = {x for x in xs if 0 <= x < 32}
            total += len(ys) * len(xs)
    assert total / 32 ** 2 == got
    with open(FM.__file__.replace("fused_mbconv.py",
                                  "csrc/fused_sepconv.cu")) as f:
        header = f.read().split("#include")[0]
    assert f"{factor:.2f}x" in header and "16.00x" in header


# ---------------------------------------------------------------------------
# B2 (kernels/fused_mbconv_train.py::train_plan("b2", ...))

def _b2_instantiations():
    with open(FMT.__file__.replace("fused_mbconv_train.py",
                                   "csrc/fused_mbconv_train.cu")) as f:
        src = f.read()
    import re
    block = src[src.index("#define B2_CASES"):]
    block = block[:block.index("\n\n")]
    return {(int(a), int(b)) for a, b in
            re.findall(r"X\((\d+), (\d+)\)", block)}


def _b2_cases():
    for B in (2, 16):
        for cin, ce, cout, rate, hw in MAIN:
            yield B, hw, hw, ce, cout
    for cin, ce, cout, rate, _ in MAIN:
        for H, W in ((37, 21), (26, 7), (19, 35)):
            yield 2, H, W, ce, cout
    for rate, cin, ce, H, W in TRAIN_GPU_SHAPES:
        for cout in (8, 16, 24, 64):
            yield 2, H, W, ce, cout


@pytest.mark.parametrize("case", sorted(set(_b2_cases())))
def test_b2_plan_fits_and_is_instantiated(case):
    B, H, W, ce, cout = case
    p = FMT.train_plan("b2", B, H, W, 8, ce, cout, 1)
    assert p.phase == "b2" and p.warps == FMT.B2_WARPS
    assert p.smem <= LIMIT
    assert p.smem == FMT.b2_smem(cout, p.ck, p.stages)
    assert p.ck in FMT.B2_NT and p.nt in FMT.B2_NT[p.ck]
    assert (p.ck, p.nt) in _b2_instantiations()
    assert set(_b2_instantiations()) == {(c, n) for c, ns in
                                         FMT.B2_NT.items() for n in ns}
    assert p.stages in (2, 3)
    # dW2's warps hold every n-tile of Cout
    assert p.nt * (FMT.B2_WARPS // (p.ck // 16)) * 8 >= cout
    groups = -(-B * H * W // FMT.B2_GP)
    assert 1 <= p.splits <= min(groups, 65535)


@pytest.mark.parametrize("case", [
    (16, 128, 128, 144, 24), (16, 64, 64, 960, 320), (16, 64, 64, 576, 160),
    (2, 37, 21, 384, 96), (2, 26, 7, 192, 32), (2, 19, 35, 960, 160),
    (2, 16, 13, 200, 64), (2, 8, 8, 96, 16)])
def test_b2_covers_every_output_once(case):
    """b2_kernel's index arithmetic, mirrored: the chunks and splits take
    each (64-pixel group, channel chunk) once; within a group the ddh
    warps hold each (pixel, channel) once, the dW2 warps each (channel,
    output channel) once, and the T1/T2 sums each channel once per pixel
    m-tile."""
    B, H, W, ce, cout = case
    p = FMT.train_plan("b2", B, H, W, 8, ce, cout, 1)
    P, ceb, nt2 = B * H * W, p.ck, p.nt
    groups = -(-P // FMT.B2_GP)
    n_chunks = -(-ce // ceb)
    pairs = {}
    for c in range(n_chunks):
        for split in range(p.splits):
            n_mine = (groups - split + p.splits - 1) // p.splits
            for i in range(n_mine):
                key = (split + i * p.splits, c)
                pairs[key] = pairs.get(key, 0) + 1
    assert len(pairs) == groups * n_chunks and set(pairs.values()) == {1}
    ntd, wm2_n = ceb // 32, ceb // 16
    ddh, dw2, tsum = {}, {}, {}
    for warp in range(FMT.B2_WARPS):
        wmd, wnd = warp & 3, warp >> 2
        for j in range(ntd):
            for r in range(16):
                for cc in range(8):
                    key = (wmd * 16 + r, (wnd * ntd + j) * 8 + cc)
                    ddh[key] = ddh.get(key, 0) + 1
            for cc in range(8):
                key = (wmd, (wnd * ntd + j) * 8 + cc)
                tsum[key] = tsum.get(key, 0) + 1
        wm2, wn2 = warp % wm2_n, warp // wm2_n
        for j in range(nt2):
            nt = wn2 * nt2 + j
            if nt >= cout // 8:
                continue
            for r in range(16):
                for cc in range(8):
                    key = (wm2 * 16 + r, nt * 8 + cc)
                    dw2[key] = dw2.get(key, 0) + 1
    assert len(ddh) == FMT.B2_GP * ceb and set(ddh.values()) == {1}
    assert len(tsum) == 4 * ceb and set(tsum.values()) == {1}
    assert len(dw2) == ceb * cout and set(dw2.values()) == {1}


# ---------------------------------------------------------------------------
# F1 and F3 (kernels/fused_mbconv_train.py::train_plan("f1" / "f3"))

def _cu_source():
    with open(FMT.__file__.replace("fused_mbconv_train.py",
                                   "csrc/fused_mbconv_train.cu")) as f:
        return f.read()


def _f3_instantiations():
    import re
    src = _cu_source()
    block = src[src.index("#define F3_CASES"):]
    block = block[:block.index("\n\n")]
    return {(int(a), int(b)) for a, b in
            re.findall(r"X\((\d+), (\d+)\)", block)}


def _f13_cases():
    """The 9 block shapes at the training batch on their own maps, and at
    two ragged pixel counts (2 x 37 x 21, 2 x 26 x 7): (B, H, W, Cin, Ce,
    Cout)."""
    for cin, ce, cout, rate, hw in MAIN:
        yield 16, hw, hw, cin, ce, cout
        for H, W in ((37, 21), (26, 7)):
            yield 2, H, W, cin, ce, cout


F13_CASES = list(_f13_cases())


def test_f13_cases_are_the_nine_block_shapes():
    assert len({c[3:] for c in F13_CASES}) == 9 and len(F13_CASES) == 27


@pytest.mark.parametrize("case", F13_CASES)
def test_f1_plan_fits_and_is_instantiated(case):
    B, H, W, cin, ce, cout = case
    p = FMT.train_plan("f1", B, H, W, cin, ce, cout, 1)
    assert p.phase == "f1" and p.smem <= LIMIT
    wgs = p.ck // 64
    assert wgs in FMT.F1_WGS and p.ck == 64 * wgs and p.warps == 4 * wgs
    assert f"f1_kernel<{wgs}>" in _cu_source()
    assert p.smem == FMT.f1_smem(cin, wgs)
    assert p.stages == FMT.F1_STAGES and p.nt == 0
    assert "F1_STAGES = %d;" % FMT.F1_STAGES in _cu_source()
    tiles = -(-B * H * W // FMT.F1_GP)
    assert 1 <= p.splits <= min(tiles, 65535)
    # one wave: the blocks an SM holds, times the SMs
    per_sm = FMT._blocks_per_sm(p.smem, 128 * wgs)
    assert -(-ce // p.ck) * p.splits <= max(per_sm * FM.SM_COUNT,
                                            -(-ce // p.ck))


@pytest.mark.parametrize("case", F13_CASES)
def test_f3_plan_fits_and_is_instantiated(case):
    B, H, W, cin, ce, cout = case
    p = FMT.train_plan("f3", B, H, W, cin, ce, cout, 1)
    assert p.phase == "f3" and p.smem <= LIMIT and p.ck == FMT.F3_CK
    assert (p.nt, p.tw) in _f3_instantiations() and p.th == FMT.F3_PM
    assert _f3_instantiations() == set(FMT.F3_CASES)
    assert "F3_PM = %d," % FMT.F3_PM in _cu_source()
    assert 8 * p.nt in (32, 64, 96, 128, 160)   # gmma_m64<N>'s widths
    assert p.smem == FMT.f3_smem(ce, p.nt, p.tw, p.stages)
    assert p.stages in FMT.F3_STAGES
    assert p.warps == 8 * p.tw
    assert p.splits == -(-cout // FMT._f3_cols(p.nt, p.tw))
    # the fewest splits the instantiated widths allow
    assert p.splits == min(-(-cout // FMT._f3_cols(n, c))
                           for n, c in _f3_instantiations())


@pytest.mark.parametrize("case", FMT.F3_CASES)
def test_every_f3_case_is_chosen_at_some_cout(case):
    """No instantiation of f3_kernel is a knob that no shape selects."""
    plans = [FMT.train_plan("f3", 2, 8, 8, 8, 192, cout, 1)
             for cout in range(8, 321, 8)]
    assert case in {(p.nt, p.tw) for p in plans}


@pytest.mark.parametrize("wgs", FMT.F1_WGS)
def test_every_f1_warpgroup_count_is_chosen_at_some_cin(wgs):
    """No instantiation of f1_kernel is a knob that no shape selects."""
    assert [cin for cin in range(8, 161, 8) if FMT.train_plan(
        "f1", 2, 8, 8, cin, 192, 8, 1).ck == 64 * wgs]


def _f1_coverage(P, ce, wgs, splits):
    """f1_kernel's index arithmetic, mirrored: the (pixel, channel) values
    each block's warps sum, and the (split, stat, channel) partials it
    writes.  Returns the count of each pixel tile over the splits, of
    each (row, column) of a tile over a warpgroup's threads, and of each
    partial."""
    nb = 64 * wgs
    tiles = -(-P // FMT.F1_GP)
    n_chunks = -(-ce // nb)
    tile_count = np.zeros(tiles, int)
    for split in range(splits):
        n_mine = (tiles - split + splits - 1) // splits
        for i in range(n_mine):
            tile_count[split + i * splits] += 1
    # one warpgroup: warp w (of 4), lane (g, t), d[4j + 2h + e]
    rc = np.zeros((64, 64), int)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(8):
                for h in range(2):
                    for e in range(2):
                        rc[16 * w + g + 8 * h, 8 * j + 2 * t + e] += 1
    part = np.zeros((splits, 2, ce), int)
    for chunk in range(n_chunks):
        c0 = chunk * nb
        for split in range(splits):
            for e in range(2 * nb):
                w, c = e // nb, e % nb
                if c0 + c < ce:
                    part[split, w, c0 + c] += 1
    return tile_count, rc, part


@pytest.mark.parametrize("case", [c for c in F13_CASES if c[0] == 16]
                         + [(2, 37, 21, 160, 960, 320), (2, 26, 7, 24, 144,
                                                         24)])
def test_f1_covers_every_pixel_channel_and_partial_once(case):
    B, H, W, cin, ce, cout = case
    p = FMT.train_plan("f1", B, H, W, cin, ce, cout, 1)
    tiles, rc, part = _f1_coverage(B * H * W, ce, p.ck // 64, p.splits)
    assert set(tiles) == {1}
    assert set(rc.ravel()) == {1}
    assert set(part.ravel()) == {1}
    # the x tile's 16-byte chunks: row r = e % 64, chunk q = e / 64 cover
    # each (row, chunk) of the kp-wide tile once, and each row's chunk
    # lands in its piece at a distinct swizzled slot
    kp = -(-cin // FMT.F1_KP) * FMT.F1_KP
    slots = {((q >> 2), r, (q & 3) ^ ((r >> 1) & 3))
             for e in range(64 * kp // 8) for r, q in [(e & 63, e >> 6)]}
    assert len(slots) == 64 * kp // 8


@pytest.mark.parametrize("case", [c for c in F13_CASES if c[0] == 16]
                         + [(2, 37, 21, 96, 576, 160), (2, 26, 7, 160, 960,
                                                        320)])
def test_f3_covers_every_output_once(case):
    """f3_kernel's index arithmetic, mirrored: the 1-D grid's (tile, split)
    pairs once each; within a block the warps' stored (row, column) once
    each and every stored column's n-tile pair computed; over the splits
    every column of Cout once."""
    B, H, W, cin, ce, cout = case
    p = FMT.train_plan("f3", B, H, W, cin, ce, cout, 1)
    P, n, pm, cw, splits = B * H * W, 8 * p.nt, p.th, p.tw, p.splits
    nblk = FMT._f3_cols(p.nt, cw)
    blocks = -(-P // pm) * splits
    pairs = np.zeros((blocks // splits, splits), int)
    for b in range(blocks):
        pairs[b // splits, b % splits] += 1
    assert set(pairs.ravel()) == {1}
    cols = np.zeros(cout, int)
    for split in range(splits):
        n0 = split * nblk
        seen = np.zeros((pm, nblk), int)
        for warp in range(p.warps):
            wg = warp >> 2
            arow, bcol = 64 * (wg % 2), n * (wg // 2)
            if n0 + bcol >= cout:          # the warpgroup skips its product
                continue
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(n // 8):
                    col = bcol + 8 * j + 2 * t
                    if n0 + col >= cout:
                        continue
                    for h in range(2):
                        row = arow + 16 * (warp & 3) + g + 8 * h
                        seen[row, col] += 1
                        seen[row, col + 1] += 1
        real = min(nblk, cout - n0)
        assert set(seen[:, :real].ravel()) == {1}
        assert not seen[:, real:].any()
        cols[n0:n0 + real] += 1
    assert set(cols) == {1}


# fused_dw_bn_relu6's launches: block 0 of a B=8 request at 512x512, at the
# test-time augmentation's 384x384 and 640x640 and at VOC's 375x500; the
# JAX kernel's documented shape; a C that is not a multiple of 4; a ragged
# map; a rate past the map
DW_SHAPES = [(8, 256, 256, 32, 1), (8, 192, 192, 32, 1),
             (8, 320, 320, 32, 1), (8, 188, 250, 32, 1),
             (8, 64, 64, 384, 2), (2, 20, 36, 7, 1), (2, 37, 53, 24, 4),
             (1, 32, 32, 16, 18)]


def _dw_cover(n_blocks, per_block, inside):
    """How often each index along one axis is an output: block b's item i
    writes b * per_block + i where ``inside`` says (the kernel's
    ``x0 + px < W``, ``j < rows_out`` and ``c < C``)."""
    seen = {}
    for b in range(n_blocks):
        for i in range(per_block):
            idx = b * per_block + i
            if inside(idx):
                seen[idx] = seen.get(idx, 0) + 1
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_plan_fits_and_covers_each_output_once(monkeypatch, shape, dtype):
    """At every shape, with the plan's own choice and with each strip width
    forced: the ring fits, the block's threads are its columns times its
    vectors, the launcher's checks pass, and the strips, row segments and
    channel chunks write every output exactly once."""
    B, H, W, C, rate = shape
    esize = 2 if dtype == torch.bfloat16 else 4
    strips = FDW.DW_STRIPS
    try:
        for forced in (None,) + strips:
            monkeypatch.setattr(FDW, "DW_STRIPS",
                                strips if forced is None else (forced,))
            FDW.dw_plan.cache_clear()
            p = FDW.dw_plan(B, H, W, C, rate, dtype)
            assert forced is None or p.sw == forced
            assert p.vec == FDW.dw_vec(C, esize) and C % p.vec == 0
            assert p.vec * esize <= 16
            assert p.threads == p.sw * p.cv <= FDW.DW_MAX_THREADS
            assert 1 <= p.prefetch <= max(FDW.DW_PREFETCH)
            assert p.smem == FDW.dw_smem(rate, p.sw, p.cv, p.vec, esize,
                                         p.prefetch) <= LIMIT
            assert FDW.dw_blocks_per_sm(p.threads, p.smem, p.vec, esize) >= 1
            assert p.strips_y <= 65535 and p.chunks * p.B <= 65535
            assert p.grid == (-(-W // p.sw), -(-H // p.th),
                              -(-(C // p.vec) // p.cv) * B)
            cols = _dw_cover(p.strips_x, p.sw, lambda x: x < W)
            rows = _dw_cover(p.strips_y, p.th, lambda y: y < H)
            vecs = _dw_cover(p.chunks, p.cv, lambda v: v * p.vec < C)
            assert sorted(cols) == list(range(W)) and set(cols.values()) == {1}
            assert sorted(rows) == list(range(H)) and set(rows.values()) == {1}
            assert (sorted(vecs) == list(range(C // p.vec))
                    and set(vecs.values()) == {1})
    finally:
        FDW.dw_plan.cache_clear()


@pytest.mark.parametrize("rate", [1, 2, 4, 18])
def test_dw_ring_holds_each_row_from_copy_to_last_read(rate):
    """The kernel's ring schedule, its slot counters mirrored: the prologue
    copies input rows 0 .. 2 rate + prefetch - 1; before output row j a
    thread waits until at most prefetch - 1 of its copies are pending, then
    (after the barrier) copies row j + 2 rate + prefetch, then reads rows j,
    j + rate and j + 2 rate.  Every row read must have landed and still be
    in its slot, and no copy may land in a slot this row reads."""
    for prefetch in FDW.DW_PREFETCH:
        D = 2 * rate + 1 + prefetch
        for rows_out in (1, 2, 5, 48):
            rows_in = rows_out + 2 * rate
            slot_row, issued = {}, []

            def issue(i, slot):
                issued.append(i if i < rows_in else None)   # empty group
                if i < rows_in:
                    slot_row[slot] = i

            nxt = 0
            for i in range(2 * rate + prefetch):
                issue(i, nxt)
                nxt = 0 if nxt + 1 == D else nxt + 1
            s0 = 0
            for j in range(rows_out):
                # wait_group(prefetch - 1): the groups older than the last
                # prefetch - 1 have landed
                landed = {i for i in issued[:len(issued) - (prefetch - 1)]
                          if i is not None}
                reads, s = [], s0
                for dy in range(3):
                    reads.append(s)
                    s = s + rate - D if s + rate >= D else s + rate
                assert nxt not in reads
                issue(j + 2 * rate + prefetch, nxt)
                nxt = 0 if nxt + 1 == D else nxt + 1
                for dy, slot in enumerate(reads):
                    assert slot_row[slot] == j + dy * rate
                    assert j + dy * rate in landed
                s0 = 0 if s0 + 1 == D else s0 + 1


def test_dw_plan_fills_the_card_at_block_zero():
    """Block 0 of the served request: 16-byte vectors, the deepest ring,
    256 threads, and blocks that fill the SMs' slots in whole waves to
    within 10% (a part-empty last wave leaves the memory system idle)."""
    for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2)):
        p = FDW.dw_plan(8, 256, 256, 32, 1, dtype)
        assert p.vec * esize == 16 and p.prefetch == 4
        assert p.threads == FDW.DW_MAX_THREADS
        slots = FDW.DW_SM_COUNT * FDW.dw_blocks_per_sm(p.threads, p.smem,
                                                       p.vec, esize)
        blocks = p.strips_x * p.strips_y * p.chunks * p.B
        assert blocks / (-(-blocks // slots) * slots) >= 0.9
