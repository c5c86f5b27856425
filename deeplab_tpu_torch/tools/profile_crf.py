"""Per-family device time of the dense CRF beside each family's analytic
work (the port's counterpart of the JAX repo's ``tools/profile_crf.py``).

The program is ``mean_field_batched`` on the plane engine over B=8 seeded
512x512 scenes with 21 labels, at ``--cfg mirror`` (``CrfConfig()``: the
pydensecrf parameter mirror) or ``--cfg production``
(``PRODUCTION_CONFIG``), 3 calls traced with ``profiling.trace``.  Each
device op is put in a family by its kernel's name (``_family``):
``splat_planes`` (the norm pass, f32, and the per-iteration Q splats,
bf16), the spatial blur, ``slice_attrs_planes``, ``mf_step_planes``,
reshapes/copies, and the glue (the cross-cell ``z_blur`` products, cuBLAS,
and the rest).

Beside each family's time stands its work (``analytic``): the bytes it
must move (each input read once, each output written once) and the f32
operations of the port's sparse forms, the model ``chip_smoke.py``'s
``crf_bound_ms`` uses, against an H100 SXM's 3.35 TB/s and 67 TFLOP/s
(f32; ``z_blur`` runs f32 products with TF32 off).  ``analytic_tflops``
is the JAX package's dense-matmul formulation of the same work (its MXU
form, ported with the port's unpadded grid), given for reference; at
989 TFLOP/s (bf16) it is the time the dense form would take.

    python -m deeplab_tpu_torch.tools.profile_crf [--cfg mirror|production]
        [--bs 8] [--size 512] [--logdir DIR] [--device cpu]
    python -m deeplab_tpu_torch.tools.profile_crf --trace DIR --cfg ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from deeplab_tpu_torch.tools import trace as T

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
F32_FLOP_S = 67e12          # f32 outside the tensor cores
BF16_TC_FLOP_S = 989e12     # bf16 tensor cores, dense

B, H, W, L = 8, 512, 512, 21
CALLS = 3
FAMILIES = ("splat_planes(norm)", "splat_planes(Q)", "gaussian_blur_planes",
            "slice_attrs_planes", "mf_step_planes", "z_blur (cuBLAS)",
            "reshapes/copies", "glue")


def config(name: str):
    from deeplab_tpu_torch.crf import PRODUCTION_CONFIG, CrfConfig
    return {"mirror": CrfConfig(), "production": PRODUCTION_CONFIG}[name]


def geometry(cfg, h: int = H, w: int = W, n_labels: int = L):
    """The plane engine's cell geometry of (h, w) images at ``cfg``
    (``dense_crf.CellPlan``: the JAX ``_PallasPlan`` without its TPU tile
    padding, so the grid is (nc*L, nc*nc) and the step slices a whole
    cell)."""
    from deeplab_tpu_torch.crf.dense_crf import (_cfg_color_taps,
                                                 _gauss_taps, CellPlan)
    plan = CellPlan(h, w, cfg.sxy_bilateral, cfg.srgb, cfg.color_step,
                    cfg.splat_stride, ctaps=_cfg_color_taps(cfg))
    nc, s = plan.nc, plan.stride
    return dict(nc=nc, Z=plan.Z, P=plan.P, P_sub=plan.P // (s * s),
                D=nc * n_labels, C=nc * nc, cs_y=plan.cs_y, cs_x=plan.cs_x,
                stride=s, ntaps=len(_gauss_taps(cfg.sxy_gaussian)),
                ctaps=len(plan.bb_taps), L=n_labels)


def analytic_tflops(cfg, batch: int = B, h: int = H, w: int = W,
                    n_labels: int = L):
    """The JAX package's dense matmul work per call, by family (TFLOP):
    the splat as (nc*L, P_sub) @ (P_sub, C) per plane and iteration, the
    step's color blur (nc*L, C) @ (C, C) and slice (nc*L, C) @ (C, P), the
    z-blur 2*B*Z*Z*D*C per application (n_iters + 1)."""
    g = geometry(cfg, h, w, n_labels)
    nc, Z, C, D = g["nc"], g["Z"], g["C"], g["D"]
    planes, it = batch * Z, cfg.n_iters
    splat = 2 * D * g["P_sub"] * C * planes * it
    blur = 2 * D * C * C * planes * it
    slc = 2 * D * C * g["P"] * planes * it
    zblur = 2 * batch * Z * Z * D * C * (it + 1)
    return g, {"splat_planes(Q)": splat / 1e12,
               "mf_step_planes": (blur + slc) / 1e12,
               "z_blur (cuBLAS)": zblur / 1e12}


def analytic(cfg, batch: int = B, h: int = H, w: int = W,
             n_labels: int = L):
    """{family: (bytes, f32 operations)} a call: the port's sparse forms
    (8 grid corners per (pixel, label) for the splat and the slice, the
    color stencil per grid value, 2 x taps per blurred value and the gn
    multiply, 20 operations a (pixel, label) for the step's messages,
    unary and softmax; the z-blur's dense product)."""
    g = geometry(cfg, h, w, n_labels)
    nc, Z, P, Ps, C, D = g["nc"], g["Z"], g["P"], g["P_sub"], g["C"], g["D"]
    BZ, Lb, it, s = batch * Z, g["L"], cfg.n_iters, g["stride"]
    nt = g["ctaps"]
    stencil = 2 * (nt * nt + nt)
    npl = BZ * Lb * P
    sub = 1 + (1 / (s * s) if s > 1 else 0)   # and the subsampled copies
    out = {
        "splat_planes(norm)": (BZ * Ps * (3 + 1) * 4 + BZ * nc * C * 4,
                               2 * 8 * BZ * Ps),
        "splat_planes(Q)": (it * (BZ * Ps * 4 * 4 + BZ * Lb * Ps * 2
                                  + BZ * D * C * 2),
                            it * 2 * 8 * BZ * Lb * Ps),
        "slice_attrs_planes": (BZ * P * 3 * 4 + BZ * nc * C * 4 + Z * P * 4
                               + BZ * P * 4 + sub * (BZ * P * 8 * 4
                                                     + npl * 2),
                               2 * 8 * npl + 2 * 2 * npl
                               + stencil * BZ * nc * C),
        "gaussian_blur_planes": (it * (2 * npl * 2 + Z * P * 4),
                                 it * 2 * (2 * g["ntaps"] + 1) * npl),
        "mf_step_planes": (it * (BZ * P * 7 * 4 + BZ * D * C * 2
                                 + 3 * npl * 2),
                           it * (2 * 8 * npl + 2 * 2 * npl
                                 + stencil * BZ * D * C + 20 * npl)),
        "z_blur (cuBLAS)": (2 * BZ * nc * C * 4 + it * 2 * BZ * D * C * 2,
                            2 * batch * Z * Z * nc * C
                            + it * 2 * batch * Z * Z * D * C),
    }
    return g, out


def _family(name: str) -> str:
    """The family of one device op, by its kernel's name."""
    if "mf_step" in name or "grid_blur_li_kernel" in name:
        return "mf_step_planes"
    if "splat_kernel" in name:
        # the norm pass splats f32 values into an f32 grid; the iterations
        # bf16 into bf16 (the kernel's template arguments)
        return ("splat_planes(norm)"
                if "splat_kernel<float" in name or "splat_kernelIff" in name
                else "splat_planes(Q)")
    if "slice_attrs_kernel" in name or "grid_blur_kernel" in name:
        return "slice_attrs_planes"
    if any(k in name for k in ("blur_kernel", "blur_y_kernel",
                               "blur_x_kernel")):
        return "gaussian_blur_planes"
    if "slice_fused_kernel" in name:
        return "slice_planes"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "z_blur (cuBLAS)"
    if "copy" in name.lower() or "Memcpy" in name or "Memset" in name:
        return "reshapes/copies"
    return "glue"


def run(logdir: str, cfg_name: str = "mirror", bs: int = B, size=(H, W),
        device=None):
    """Warm the CRF up, then trace ``CALLS`` calls of ``mean_field_batched``
    on ``bs`` seeded scenes into ``logdir``; returns the trace's path."""
    import torch

    from deeplab_tpu_torch import core
    from deeplab_tpu_torch.crf import mean_field_batched
    from deeplab_tpu_torch.train import profiling
    dev = core.resolve_device(device)
    cfg = config(cfg_name)
    gen = torch.Generator().manual_seed(0)
    img = (torch.rand((bs, size[0], size[1], 3), generator=gen) * 255).to(dev)
    # blocky label maps: a coarse random grid of L ids, nearest-upsampled
    coarse = torch.randint(0, L, (bs, 1, 16, 16), generator=gen).float()
    masks = torch.nn.functional.interpolate(coarse, size=tuple(size))[:, 0]
    masks = masks.to(dev, torch.int32)
    mean_field_batched(img, masks, cfg, L)
    with profiling.trace(logdir):
        for _ in range(CALLS):
            mean_field_batched(img, masks, cfg, L)
    return T.newest_trace(logdir)


def itemize(path: str, cfg_name: str = "mirror", bs: int = B, size=(H, W),
            quiet: bool = False):
    """The family table of the trace at ``path`` per call; returns the
    JSON record (with ``_ops`` and ``busy_ms`` beside it)."""
    if os.path.isdir(path):
        path = T.newest_trace(path)
    cfg, calls = config(cfg_name), CALLS
    g, work = analytic(cfg, bs, size[0], size[1])
    _, dense = analytic_tflops(cfg, bs, size[0], size[1])
    ops = T.device_ops(T.load(path))
    per_call, tops = {}, {}
    for name, _, dur, _ in ops:
        fam = _family(name)
        per_call[fam] = per_call.get(fam, 0.0) + dur / 1e3 / calls
        tops.setdefault(fam, {}).setdefault(name, 0.0)
        tops[fam][name] += dur / 1e3 / calls
    tot = sum(per_call.values())
    rows = {}
    for fam, ms in sorted(per_call.items(), key=lambda kv: -kv[1]):
        row = {"ms": ms, "share": ms / max(tot, 1e-12)}
        if fam in work:
            nbytes, flops = work[fam]
            t_b, t_o = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
            row.update(gb=nbytes / 1e9, gflop=flops / 1e9,
                       hbm_share=t_b * 1e3 / ms if ms else 0.0,
                       f32_share=t_o * 1e3 / ms if ms else 0.0,
                       bound_ms=1e3 * max(t_b, t_o),
                       bound_by="bytes" if t_b >= t_o else "operations")
        if fam in dense:
            row["dense_tflop"] = dense[fam]
            row["dense_ms_at_bf16_peak"] = dense[fam] * 1e12 / BF16_TC_FLOP_S * 1e3
        rows[fam] = row
    rec = {"metric": f"crf_{cfg_name}_kernel_ms", "bs": bs,
           "families": {k: round(v["ms"], 4) for k, v in rows.items()},
           "analytic": {k: {kk: rows[k][kk] for kk in (
               "gb", "gflop", "bound_ms", "bound_by")} for k in rows
               if "gb" in rows[k]},
           "analytic_tflop": {k: round(v, 4) for k, v in dense.items()},
           "total_ms": round(tot, 4),
           "device_img_s": round(bs / (tot / 1e3), 1) if tot else 0.0,
           "busy_ms": T.busy_us(ops) / 1e3 / calls}
    if not quiet:
        print(f"dense-CRF {cfg_name} cfg — nc={g['nc']} grid (D={g['D']}, "
              f"C={g['C']}), {cfg.n_iters} iters, B={bs}, {size[0]}x"
              f"{size[1]}, cells {g['cs_y']}x{g['cs_x']}, splat stride "
              f"{g['stride']}")
        print(f"{'family':<22} {'ms/call':>9} {'share':>6} {'GB':>7} "
              f"{'%HBM':>6} {'GFLOP':>8} {'%f32':>6} {'bound ms':>9}")
        for fam, r in rows.items():
            if "gb" in r:
                print(f"{fam:<22} {r['ms']:9.4f} {100 * r['share']:5.1f}% "
                      f"{r['gb']:7.3f} {100 * r['hbm_share']:5.1f}% "
                      f"{r['gflop']:8.2f} {100 * r['f32_share']:5.1f}% "
                      f"{r['bound_ms']:9.4f} ({r['bound_by']})")
            else:
                print(f"{fam:<22} {r['ms']:9.4f} {100 * r['share']:5.1f}% "
                      f"{'—':>7} {'—':>6} {'—':>8} {'—':>6} {'—':>9}")
        print(f"{'TOTAL':<22} {tot:9.4f} ms  ->  {rec['device_img_s']:.1f} "
              f"img/s of device op time")
        mat = sum(dense.values())
        print(f"dense (MXU-form) matmul work: {mat:.3f} TFLOP a call => "
              f"{mat * 1e12 / BF16_TC_FLOP_S * 1e3:.3f} ms at 989 TFLOP/s "
              f"bf16")
        for fam in ("glue", "reshapes/copies"):
            if fam in tops:
                print(f"\ntop ops in '{fam}':")
                for k, v in sorted(tops[fam].items(),
                                   key=lambda kv: -kv[1])[:8]:
                    print(f"  {v:8.4f} ms  {k[:110]}")
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("analytic",)}))
    rec["_ops"], rec["_rows"] = ops, rows
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", help="itemize this trace (file or directory)")
    ap.add_argument("--cfg", default="mirror",
                    choices=["mirror", "production"])
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--bs", type=int, default=B)
    ap.add_argument("--size", type=int, default=H)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    size = (args.size, args.size)
    path = args.trace or run(args.logdir or f"prof/crf_{args.cfg}",
                             args.cfg, args.bs, size, device=args.device)
    itemize(path, args.cfg, args.bs, size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
