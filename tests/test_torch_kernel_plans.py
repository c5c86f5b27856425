"""The launch plans of the two redesigned kernels, on the CPU.

``fused_mbconv``'s plan (``kernels/fused_mbconv.py::mbconv_plan``) and the
CRF row blur's (``kernels/crf_fused.py::blur_plan``) are plain Python that
the CUDA launchers check and never recompute differently.  Here: every
main-path shape fits in a block's 232,448 bytes of shared memory; the tiles,
warps and label groups cover every output exactly once, ragged edges
included (the kernels' index arithmetic, mirrored); and the recompute
factors that the sources' headers state are the plans' own.
"""

import itertools

import pytest

from deeplab_tpu_torch import crf as CRF
from deeplab_tpu_torch.crf import dense_crf as DC
from deeplab_tpu_torch.kernels import crf_fused as CK
from deeplab_tpu_torch.kernels import fused_mbconv as FM
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


def _row_blur_geometries():
    """Every (cs_y, cs_x, taps) that gaussian_blur_planes sends to the row
    kernel at the three configs, images from 128 to 1024 px a side."""
    out = set()
    for cfg in (CRF.PRODUCTION_CONFIG, CRF.FAST_FAITHFUL_CONFIG,
                CRF.THROUGHPUT_CONFIG):
        taps = DC._gauss_taps(cfg.sxy_gaussian)
        for h in range(128, 1025, 8):
            for w in (128, 500, 1024):
                plan = DC.CellPlan(1, h, w, cfg.sxy_bilateral, cfg.srgb,
                                   cfg.color_step, cfg.splat_stride)
                if CK.row_kernel_fits(taps, plan.cs_y):
                    out.add((plan.cs_y, plan.cs_x, len(taps)))
    return sorted(out)


ROW_GEOMETRIES = _row_blur_geometries()


def test_row_blur_geometries_are_found():
    assert (64, 128, 17) in ROW_GEOMETRIES
    assert {g[0] for g in ROW_GEOMETRIES} >= {64, 80}


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
