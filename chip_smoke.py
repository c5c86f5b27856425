#!/usr/bin/env python3
"""Drive the PyTorch port (deeplab_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):

1. build every CUDA kernel of the main path from ``deeplab_tpu_torch/kernels/
   csrc`` with nvcc (all sources at once);
2. hold each kernel against its plain PyTorch version: ``fused_mbconv`` at
   every distinct shape the main path gives it, under "mixed" (f32 in/out)
   and bf16 at B=2, and under "mixed" at the served batch; the four CRF
   kernels on every call of a CRF run over seeded 512x512 scenes, at
   ``PRODUCTION_CONFIG`` with B=2 and B=8 and at ``FAST_FAITHFUL_CONFIG``
   and ``THROUGHPUT_CONFIG`` with B=2;
3. the model path: ``Predictor(SegNet(512x512, 21 classes), "mixed")`` at
   full MobileNetV2 width with seeded weights serves 3 requests of 8 images;
   ``fused_mbconv``'s count must rise by exactly 14 per forward; the logits
   are compared with the same forward with the plain version in each
   kernel's place, and with the plain layer composition, on the card; and
   the float32 port on the card with the float32 port on the CPU;
4. the main path: ``Predictor(net, crf=PRODUCTION_CONFIG, "mixed",
   return_raw=True)`` serves 3 requests of 8 scenes; per request the counts
   rise by exactly fused_mbconv 14, splat 6, slice_attrs 1, blur 5, mf_step
   5; the CRF with the kernels is compared with the CRF with each plain
   version in its kernel's place, and with the exact-oracle goldens
   (tests/goldens/crf) at ``FAST_FAITHFUL_CONFIG``;
5. training: the five phase kernels of the training MBConv block
   (``fused_mbconv_train``) against their plain versions on every call of a
   bf16 train step of the full-width 512x512 net at B=2 and at B=16; then
   ``Trainer(SegNet(512x512, 21), compute_dtype=bfloat16,
   freeze_before=None).fit`` takes 6 steps on one seeded batch of B=16 with a
   float32 validation pass after each: every phase's count must rise by
   exactly 14 per step and the loss fall by at least 10%; one step with the
   kernels is compared with the same step with each phase's plain version in
   its kernel's place (loss, every parameter's gradient, BN moving
   statistics); the trained net serves one request through
   ``Predictor("mixed")``;
6. times with CUDA events after warm-up: each kernel launch at the main
   path's shapes beside its bound and its plain version (and, for the blur,
   one depthwise ``F.conv2d``), model-only img/s at B=16 under "mixed" and
   float32, the CRF alone at B=8, production end to end at B=16, and B=1
   latency with and without the CRF; each training phase per launch and per
   step beside its bound and plain version, the train step's img/s at B=16
   (bf16 with the kernels, bf16 through the plain layer composition, and
   float32) with its peak device memory, and a ``torch.profiler`` table of
   the bf16 step.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Without
CUDA, or without the port beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense): device memory rate,
# bf16 tensor-core rate, and the f32 rate outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOP_S = 989e12
F32_FLOP_S = 67e12

SIZE, CLASSES, SEED = 512, 21, 0
SERVE_B, N_REQUESTS, BENCH_B = 8, 3, 16
FUSED_PER_FORWARD = 14
# kernel vs plain version, relative to the output's largest magnitude: both
# take the same bf16 matmul operands and accumulate in f32; they differ in
# summation order, which can flip the bf16 rounding of one depthwise output
# (2^-8 relative) feeding the project, and bf16 outputs add their own 2^-8
KERNEL_REL_TOL = {"mixed": 2e-3, "bfloat16": 1e-2}
# Whole forward, "mixed", relative to the largest float32 logit.  A network
# with seeded weights has no trained margins: bf16-level differences grow
# through its 60 layers, so these bounds are looser than a trained model's.
# Kernel path vs the same forward with the plain version in each kernel's
# place: the per-launch differences above, carried through 14 blocks.
KERNEL_PATH_REL_TOL, KERNEL_PATH_FLOOR = 0.05, 0.95
# Kernel path vs the plain layer composition: the fused block rounds its
# BN-folded weights to bf16 and runs the depthwise in f32; the composition
# rounds the raw weights and the depthwise operands to bf16.  Both stray
# from float32 by bf16 rounding; the kernel path may not stray further.
LOGITS_REL_TOL, ARGMAX_FLOOR, F32_AGREE_MARGIN = 0.5, 0.8, 0.02
# float32 port on the card (TF32 off) vs on the CPU: summation order only
F32_REL_TOL = 1e-4

CRF_PER_REQUEST = {"splat_planes": 6, "slice_attrs_planes": 1,
                   "gaussian_blur_planes": 5, "mf_step_planes": 5}
# the TPU kernels they replace (file:line of the pl.pallas_call)
CRF_REPLACES = {"splat_planes": 702, "slice_attrs_planes": 890,
                "gaussian_blur_planes": 568, "mf_step_planes": 988}
# (each CRF kernel against its plain version: the PLAIN_*_REL tolerances of
# deeplab_tpu_torch/kernels/crf_fused.py)
# CRF masks with the kernels vs with the plain versions; oracle goldens
CRF_PATH_FLOOR, GOLDEN_FLOOR = 0.99, 0.993

TRAIN_B, TRAIN_STEPS, TRAIN_PER_STEP = 16, 6, 14
TRAIN_LOSS_DROP = 0.10
# (each training phase against its plain version: the PLAIN_*_REL
# tolerances of deeplab_tpu_torch/kernels/fused_mbconv_train.py, relative
# to each output's largest magnitude: bf16 outputs 2 bf16 ulps, f32 1e-3)
# One bf16 step with the phase kernels against the same step with each
# phase's plain version in its kernel's place, B=16, same weights, batch and
# dropout mask.  The two differ per launch by summation order (the
# tolerances above), and both repeat bit for bit from run to run.  Loss and
# BN moving statistics (relative to each buffer's largest value) within
# 1e-2.  Gradients: a seeded net far from its trained regime amplifies
# bf16-level differences through 17 blocks of batch-statistic BN backward
# (on the card two correct bf16 implementations differ by O(1) per
# parameter), so the yardstick is the plain bf16 layer composition's step:
# the kernel step's norm-relative gradient error per parameter (median, 90th
# percentile, worst) may be no larger than the composition's.
TRAIN_LOSS_REL, TRAIN_BN_REL = 1e-2, 1e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_scene(H, W, n_labels, seed, n_blobs=None, speckle=0.06):
    """A structured scene (image f32 0-255, mask int64): smooth color
    regions, colored blobs and speckle label noise (the scenes of the
    committed CRF goldens, tests/crf_scenes.py)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    im = np.stack([120 + 80 * np.sin(yy / 25 + seed),
                   100 + 60 * np.cos(xx / 19),
                   90 + 50 * np.sin((xx + yy) / 33)], -1)
    mask = np.zeros((H, W), np.int64)
    n_blobs = n_blobs if n_blobs is not None else max(n_labels // 2, 3)
    for k in range(1, n_blobs + 1):
        cy = rng.randint(H // 8, H - H // 8)
        cx = rng.randint(W // 8, W - W // 8)
        r = rng.randint(min(H, W) // 10, min(H, W) // 4)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        mask[blob] = k % n_labels
        im[blob] = im[blob] * 0.3 + rng.randint(0, 255, 3) * 0.7
    sp = rng.rand(H, W) < speckle
    mask[sp] = rng.randint(0, n_labels, int(sp.sum()))
    im = np.clip(im + rng.randn(H, W, 3) * 6, 0, 255).astype(np.float32)
    return im, mask


# (name, H, W, n_labels, seed) of the committed goldens
GOLDEN_SCENES = [("s48_5l", 48, 48, 5, 0), ("s96_21l", 96, 96, 21, 3),
                 ("s128_21l", 128, 128, 21, 5), ("s80x120_11l", 80, 120, 11, 7),
                 ("s64x256_21l", 64, 256, 21, 9)]


def scene_batch(B, seed, device):
    """B seeded 512x512 scenes with 21-label masks, on ``device``."""
    import numpy as np
    pairs = [make_scene(SIZE, SIZE, CLASSES, seed + i) for i in range(B)]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])).to(device),
            torch.from_numpy(np.stack([p[1] for p in pairs])).to(device))


def tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors(v)]
    return []


def crf_bound_ms(CK, name, args, kw, out):
    """Least time for one launch: the bytes it must move at 3.35 TB/s (each
    output written once, each input read once, and of packed attrs planes
    only the rows the kernel reads: rgb and ATTR_BSCALE for the splat, all
    but ATTR_BSCALE for mf_step), against the f32 operations the sparse
    form needs at 67 TFLOP/s (2 per multiply-add: 8 grid corners per
    (pixel, label) for the splat and the slice, the color-blur stencil per
    grid value, 2 x 17 taps per blurred value)."""
    rows_read = {"splat_planes": 4, "mf_step_planes": CK.ATTR_ROWS - 1}
    nbytes = sum(t.numel() * t.element_size()
                 for t in tensors(args[1:]) + tensors(kw) + tensors(out))
    first = args[0]
    share = (rows_read[name] / CK.ATTR_ROWS if name in rows_read
             and first.shape[1] == CK.ATTR_ROWS else 1)
    nbytes += first.numel() * first.element_size() * share
    if name == "gaussian_blur_planes":
        ops = 2 * (2 * len(kw["taps"]) + 1) * out.numel()
    else:
        # (pixel, label) pairs: the values splatted, or the Q sliced
        if name == "splat_planes":
            n_pl = args[1].numel()
        else:
            n_pl = out[1 if name == "slice_attrs_planes" else 0].numel()
        ops = 2 * 8 * n_pl
        if name != "splat_planes":
            nt = len(kw["ctaps"])
            grid = args[1]
            ops += 2 * 2 * n_pl + 2 * (nt * nt + nt) * grid.numel()
        if name == "mf_step_planes":
            ops += 20 * n_pl                  # messages, unary, softmax
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def seeded_net(image_size, seed, device):
    """Full-width SegNet with seeded weights and non-trivial BN statistics.
    Glorot weights alone shrink the signal through 60 layers, so each BN
    takes its moving statistics from its own input on one seeded batch
    (layer by layer, in one forward) times a seeded jitter, and seeded
    gamma/beta: every layer then carries activations of order 1."""
    from deeplab_tpu_torch import SegNet
    from deeplab_tpu_torch.ops.bn import BatchNorm
    net = SegNet(image_size, CLASSES, seed=seed, fuse_blocks=False)
    gen = torch.Generator().manual_seed(seed + 1)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for bn in bns:
            c = bn.gamma.shape[0]
            bn.gamma.copy_(0.5 + torch.rand(c, generator=gen))
            bn.beta.copy_(torch.rand(c, generator=gen) - 0.5)
    net = net.to(device).eval()
    jitter = {bn: 0.8 + 0.4 * torch.rand(bn.gamma.shape[0], generator=gen)
              for bn in bns}

    def calibrate(bn, args):
        x = args[0].float()
        bn.moving_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.moving_variance.copy_(x.var(dim=(0, 2, 3), unbiased=False)
                                 * jitter[bn].to(x.device) + 1e-3)

    hooks = [bn.register_forward_pre_hook(calibrate) for bn in bns]
    img = torch.rand((2,) + tuple(image_size) + (3,), generator=gen) * 255
    net.logits(img.to(device), "float32")
    for h in hooks:
        h.remove()
    net.fuse_blocks = True
    return net


def fused_shapes(M):
    """Distinct (block ids, Cin, Ce, Cout, rate, skip, map stride) of the
    fused blocks, from the block table of the mobilenetv2 module ``M``."""
    shapes, c, stride_total = {}, 32, 2
    for filters, stride, expansion, block_id, skip, rate in M.BLOCK_TABLE:
        stride_total *= stride
        cout = M.make_divisible(filters, 8)
        if block_id and stride == 1:
            key = (c, expansion * c, cout, rate, skip, stride_total)
            shapes.setdefault(key, []).append(block_id)
        c = cout
    return [(ids, *k) for k, ids in shapes.items()]


def bound_ms(B, H, W, cin, ce, cout, act_bytes):
    px = B * H * W
    bytes_ = (px * (cin + cout) * act_bytes
              + 2 * (cin * ce + ce * cout) + 4 * (11 * ce + cout))
    t_bytes = bytes_ / HBM_BYTES_S
    t_tc = 2 * px * (cin * ce + ce * cout) / BF16_TC_FLOP_S
    t_fp32 = 18 * px * ce / F32_FLOP_S
    t = max(t_bytes, t_tc, t_fp32)
    return 1e3 * t, ("bytes" if t == t_bytes else "operations")


def train_bound_ms(name, args, out):
    """Least time for one training phase launch: its inputs read once and
    outputs written once at 3.35 TB/s, against its bf16 tensor-core flops at
    989 TFLOP/s and its f32 flops at 67 TFLOP/s (taps 18 per value, the
    affines, masks and sums a few more).  Products: F1 and F2 the expand
    (2 P Cin Ce); F3 the project (2 P Ce Cout); B2 ddh and dW2 (4 P Ce Cout);
    B34 the expand it needs, dx and dW1^T (6 P Cin Ce) -- its ddh is an
    input here, B2 made it."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in tensors(args) + tensors(out))
    first = args[0]
    P = first.numel() // first.shape[-1]
    if name in ("f1", "f2", "b34"):
        cin, ce = args[3].shape if name == "b34" else args[1].shape
        tc = 2 * P * cin * ce * (3 if name == "b34" else 1)
    else:
        ce, cout = args[3].shape if name == "f3" else args[7].shape
        tc = 2 * P * ce * cout * (2 if name == "b2" else 1)
    f32 = {"f1": 3, "f2": 25, "f3": 4, "b2": 10, "b34": 50}[name] * P * ce
    t_b, t_tc, t_f = nbytes / HBM_BYTES_S, tc / BF16_TC_FLOP_S, f32 / F32_FLOP_S
    t = max(t_b, t_tc, t_f)
    return 1e3 * t, ("bytes" if t == t_b else "operations")


class Run:
    def __init__(self):
        self.failed = []

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:  # a failed phase fails the run, after the others
            traceback.print_exc(file=sys.stdout)
            self.failed.append(name)
            out = None
        print(f"== {name}: {'FAILED' if name in self.failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    from deeplab_tpu_torch import Predictor
    from deeplab_tpu_torch import crf as CRF
    from deeplab_tpu_torch.crf import dense_crf as DC
    from deeplab_tpu_torch.kernels import build
    from deeplab_tpu_torch.kernels import crf_fused as CK
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
    from deeplab_tpu_torch.models import mobilenetv2 as M
    from deeplab_tpu_torch.data.generator import ArrayBatcher
    from deeplab_tpu_torch.train import Trainer
    from deeplab_tpu_torch import core

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    run = Run()
    kernel_report = {}
    crf_report = {n: {"max_abs_err": 0.0} for n in CK.KERNELS}
    crf_b8 = {}

    train_report = {n: {"max_abs_err": 0.0} for n in FMT.PHASES}
    train = {}

    def zero_counts():
        FM.fused_mbconv.launches = 0
        for n in CK.KERNELS:
            getattr(CK, n).launches = 0
        for n in FMT.PHASES:
            getattr(FMT, n).launches = 0

    def counts():
        out = {"fused_mbconv": FM.fused_mbconv.launches}
        out.update({n: getattr(CK, n).launches for n in CK.KERNELS})
        out.update({"train_" + n: getattr(FMT, n).launches
                    for n in FMT.PHASES})
        return out

    def set_counts(saved):
        FM.fused_mbconv.launches = saved["fused_mbconv"]
        for n in CK.KERNELS:
            getattr(CK, n).launches = saved[n]
        for n in FMT.PHASES:
            getattr(FMT, n).launches = saved["train_" + n]

    # 1. build --------------------------------------------------------------
    def do_build():
        t0 = time.perf_counter()
        logs = build.build(["fused_mbconv", "crf_fused",
                            "fused_mbconv_train"])
        print(f"build seconds: {time.perf_counter() - t0:.2f}")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"  [{name}] {line.strip()}")
    run.phase("build", do_build)
    if run.failed:
        return 1

    net = run.phase("seeded 512x512 net",
                    lambda: seeded_net((SIZE, SIZE), SEED, dev))
    if net is None:
        return 1
    shapes = fused_shapes(M)
    print(f"fused block shapes: {shapes}")

    def block_inputs(ids, cin, H, W, B, policy, gen):
        weights, mxu = FM.fold_block(net, M._prefix(ids[0]), policy)
        x = torch.randn((B, H, W, cin), generator=gen).to(dev, policy.dtype)
        return x, weights, mxu

    # 2. kernel vs plain version at every shape --------------------------
    def check_kernels():
        gen = torch.Generator().manual_seed(SEED + 2)
        worst = 0.0
        # B=2 in both modes, and the served batch in the served mode
        for pol_name, B in (("mixed", 2), ("bfloat16", 2),
                            ("mixed", SERVE_B)):
            pol = core.resolve_compute_dtype(pol_name)
            for ids, cin, ce, cout, rate, skip, st in shapes:
                H = W = SIZE // st
                x, w, mxu = block_inputs(ids, cin, H, W, B, pol, gen)
                got = FM.fused_mbconv(x, *w, rate=rate, skip=skip,
                                      mxu_bf16=mxu)
                ref = FM.fused_mbconv_reference(x, *w, rate=rate, skip=skip,
                                                mxu_bf16=mxu)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                rel = err / max(scale, 1e-30)
                tol = KERNEL_REL_TOL[pol_name]
                ok = math.isfinite(err) and rel <= tol
                print(f"  {pol_name:8s} blocks {ids} {cin}->{ce}->{cout} "
                      f"rate {rate} skip {skip} map {H}x{W} B={B}: max_abs "
                      f"{err:.3e} max|ref| {scale:.3e} rel {rel:.3e} "
                      f"(tol {tol}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees at {ids}")
                worst = max(worst, err)
        kernel_report["max_abs_err"] = worst
    run.phase("kernel vs plain version", check_kernels)

    def check_crf_kernels():
        cases = (("PRODUCTION_CONFIG", 2), ("PRODUCTION_CONFIG", SERVE_B),
                 ("FAST_FAITHFUL_CONFIG", 2), ("THROUGHPUT_CONFIG", 2))
        for cfg_name, B in cases:
            imgs, masks = scene_batch(B, SEED + 10, dev)
            with torch.inference_mode(), CK.plain_versions() as calls:
                CRF.mean_field_batched(imgs, masks, getattr(CRF, cfg_name),
                                       CLASSES)
            for name in CK.KERNELS:
                kernel = getattr(CK, name)
                errs = []
                for args, kw, want in calls[name]:
                    with torch.inference_mode():
                        got = kernel(*args, **kw)
                    torch.cuda.synchronize()
                    err, ok = CK.max_err_vs_plain(name, got, want)
                    errs.append(err)
                    if not ok:
                        raise AssertionError(f"{name} disagrees at "
                                             f"{cfg_name} B={B}: {err}")
                rep = crf_report[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], max(errs))
                print(f"  {cfg_name:20s} B={B} {name:20s} {len(errs)} calls: "
                      f"max_abs {max(errs):.3e} (rel tol: f32 "
                      f"{CK.PLAIN_F32_REL}, bf16 {CK.PLAIN_BF16_REL:.4g}, "
                      f"step Q {CK.PLAIN_STEP_REL:.4g}) ok")
            if cfg_name == "PRODUCTION_CONFIG" and B == SERVE_B:
                crf_b8.update(calls)
    run.phase("CRF kernels vs plain versions", check_crf_kernels)

    # 3. the main path ---------------------------------------------------
    def serve():
        gen = torch.Generator().manual_seed(SEED + 3)
        reqs = [(torch.rand((SERVE_B, SIZE, SIZE, 3), generator=gen) * 255)
                .numpy() for _ in range(N_REQUESTS)]
        pred = Predictor(net, compute_dtype="mixed")
        zero_counts()
        masks = [pred(r) for r in reqs]
        launches = FM.fused_mbconv.launches
        print(f"  served {N_REQUESTS} requests of B={SERVE_B}: fused_mbconv "
              f"launches {launches} (want {FUSED_PER_FORWARD * N_REQUESTS})")
        assert launches == FUSED_PER_FORWARD * N_REQUESTS, launches
        for m in masks:
            assert m.shape == (SERVE_B, SIZE, SIZE) and m.dtype == np.int32
            assert m.min() >= 0 and m.max() < CLASSES
        print(f"  classes present in the masks: "
              f"{len(np.unique(np.concatenate(masks)))}")

        img = torch.from_numpy(reqs[0]).to(dev)
        fused = net.logits(img, "mixed").float()
        assert torch.isfinite(fused).all()
        # the same forward with each kernel call replaced by its plain version
        kernel = FM.fused_mbconv
        FM.fused_mbconv = FM.fused_mbconv_reference
        try:
            in_situ = net.logits(img, "mixed").float()
        finally:
            FM.fused_mbconv = kernel
        # the plain layer composition, under "mixed" and under float32
        net.fuse_blocks = False
        try:
            plain = net.logits(img, "mixed").float()
            f32 = net.logits(img, "float32").float()
        finally:
            net.fuse_blocks = True
        agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        scale = f32.abs().max().item()
        err_k = (fused - in_situ).abs().max().item()
        err_p = (fused - plain).abs().max().item()
        print(f"  B={SERVE_B}, mixed, max|logit| {scale:.4e}:")
        print(f"    kernel path vs plain version in its place: max_abs "
              f"{err_k:.4e} (rel tol {KERNEL_PATH_REL_TOL}), argmax agreement "
              f"{agree(fused, in_situ):.5f} (floor {KERNEL_PATH_FLOOR})")
        print(f"    kernel path vs plain layer composition: max_abs "
              f"{err_p:.4e} (rel tol {LOGITS_REL_TOL}), argmax agreement "
              f"{agree(fused, plain):.5f} (floor {ARGMAX_FLOOR})")
        print(f"    argmax agreement with float32: kernel path "
              f"{agree(fused, f32):.5f}, plain composition "
              f"{agree(plain, f32):.5f} (kernel path may trail by at most "
              f"{F32_AGREE_MARGIN})")
        assert err_k <= KERNEL_PATH_REL_TOL * scale
        assert agree(fused, in_situ) >= KERNEL_PATH_FLOOR
        assert err_p <= LOGITS_REL_TOL * scale
        assert agree(fused, plain) >= ARGMAX_FLOOR
        assert agree(fused, f32) >= agree(plain, f32) - F32_AGREE_MARGIN

        small = seeded_net((64, 64), SEED, torch.device("cpu"))
        x = torch.rand((2, 64, 64, 3), generator=gen) * 255
        cpu = small.logits(x, "float32")
        gpu = small.to(dev).logits(x.to(dev), "float32").cpu()
        err = (gpu - cpu).abs().max().item()
        scale = cpu.abs().max().item()
        print(f"  float32 port, card vs CPU (64x64, B=2): max_abs {err:.3e} "
              f"max|logit| {scale:.3e} (rel tol {F32_REL_TOL})")
        assert err <= F32_REL_TOL * scale
    run.phase("model path: Predictor(mixed) serving", serve)

    def serve_crf():
        cfg = CRF.PRODUCTION_CONFIG
        reqs = [scene_batch(SERVE_B, SEED + 100 + 10 * i, "cpu")[0].numpy()
                for i in range(N_REQUESTS)]
        pred = Predictor(net, crf=cfg, compute_dtype="mixed", return_raw=True)
        zero_counts()
        outs = [pred(r) for r in reqs]
        got = counts()
        crf_report["launches"] = got
        want = {k: 0 for k in got}
        want["fused_mbconv"] = FUSED_PER_FORWARD * N_REQUESTS
        want.update({n: k * N_REQUESTS for n, k in CRF_PER_REQUEST.items()})
        print(f"  served {N_REQUESTS} requests of B={SERVE_B} at "
              f"PRODUCTION_CONFIG: launches {got} (want {want})")
        assert got == want, (got, want)
        for raw, ref in outs:
            for m in (raw, ref):
                assert m.shape == (SERVE_B, SIZE, SIZE), m.shape
                assert m.dtype == np.int32 and m.min() >= 0
                assert m.max() < CLASSES
        moved = np.mean([(r != f).mean() for r, f in outs])
        print(f"  the CRF changed {moved:.4f} of the pixels")

        # the same CRF with each plain version in its kernel's place
        img = torch.from_numpy(reqs[0]).to(dev)
        raw0 = torch.from_numpy(outs[0][0]).to(dev)

        def crf_q():
            plan = DC.cell_plan(*raw0.shape, cfg, dev)
            with torch.inference_mode(), \
                    core.precision_flags(core.Policy(torch.float32)):
                rgb = plan.cells_v(img.permute(0, 3, 1, 2))
                lab = plan.cells_v(raw0[:, None].to(torch.int32))
                return DC._mean_field_planes(plan, cfg, CLASSES, rgb,
                                             lab).float()
        q_k = crf_q()
        with CK.plain_versions():
            q_p = crf_q()
        agree = (q_k.argmax(1) == q_p.argmax(1)).float().mean().item()
        err = (q_k - q_p).abs().max().item()
        print(f"  CRF with kernels vs with plain versions (B={SERVE_B}): Q "
              f"max_abs {err:.4e}, mask agreement {agree:.6f} (floor "
              f"{CRF_PATH_FLOOR})")
        assert agree >= CRF_PATH_FLOOR
        # the Predictor handed the CRF the raw image and the model's masks
        agree = float((outs[0][1] == plan_masks(q_k)).mean())
        print(f"  Predictor's refined masks vs this CRF run: {agree:.6f}")
        assert agree >= CRF_PATH_FLOOR

        # exact-oracle goldens, the kernels on the card
        import os
        gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "goldens", "crf")
        for name, H, W, L, seed in GOLDEN_SCENES:
            golden = np.load(os.path.join(gdir, name + ".npz"))["golden"]
            im, mask = make_scene(H, W, L, seed)
            with torch.inference_mode():
                out = CRF.mean_field_batched(
                    torch.from_numpy(im)[None].to(dev),
                    torch.from_numpy(mask)[None].to(dev),
                    CRF.FAST_FAITHFUL_CONFIG, L)[0].cpu().numpy()
            agree = float((out == golden).mean())
            print(f"  golden {name} at FAST_FAITHFUL_CONFIG: oracle agreement "
                  f"{agree:.5f} (floor {GOLDEN_FLOOR})")
            assert agree >= GOLDEN_FLOOR, (name, agree)

    def plan_masks(q):
        plan = DC.cell_plan(SERVE_B, SIZE, SIZE, CRF.PRODUCTION_CONFIG, dev)
        pred = torch.argmax(q, dim=1, keepdim=True)
        return plan.uncells_v(pred, 1)[:, 0].to(torch.int32).cpu().numpy()
    run.phase("main path: Predictor(crf=PRODUCTION_CONFIG, mixed) serving",
              serve_crf)

    # 5. training ---------------------------------------------------------
    def train_batch(B, seed):
        """B seeded 512x512 scenes with their 21-label masks as labels, all
        weights 1, on the card."""
        imgs, masks = scene_batch(B, seed, dev)
        return (imgs, masks.reshape(B, -1, 1).to(torch.int32),
                torch.ones((B, SIZE * SIZE), device=dev))

    def label(args):
        return " ".join("x".join(map(str, t.shape)) for t in tensors(args)
                        if t.dim() >= 2)

    def check_train_kernels():
        tnet = seeded_net((SIZE, SIZE), SEED + 5, dev)
        train["net"] = tnet
        train["init"] = {k: v.clone() for k, v in tnet.state_dict().items()}
        for B in (2, TRAIN_B):
            X, Y, SW = train_batch(B, SEED + 400)
            tr = Trainer(tnet, compute_dtype=torch.bfloat16, device=dev,
                         verbose=0)
            tr.setup(tnet)
            with FMT.plain_versions() as calls:
                tr.train_step(X, Y, SW)
            for name in FMT.PHASES:
                kernel = getattr(FMT, name)
                assert len(calls[name]) == TRAIN_PER_STEP, len(calls[name])
                worst = (0.0, 0.0)
                for args, kw, want in calls[name]:
                    with torch.no_grad():
                        got = kernel(*args, **kw)
                    torch.cuda.synchronize()
                    err, rel, ok = FMT.max_err_vs_plain(got, want)
                    if B == 2:
                        print(f"  {name:4s} B=2 {label(args)}: max_abs "
                              f"{err:.3e}, rel {rel:.3e} "
                              f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees at B={B}: "
                                             f"{label(args)} {err} {rel}")
                    worst = max(worst, (rel, err))
                    rep = train_report[name]
                    rep["max_abs_err"] = max(rep["max_abs_err"], err)
                print(f"  {name:4s} B={B}: {len(calls[name])} calls within "
                      f"tolerance (rel: bf16 {FMT.PLAIN_BF16_REL:.4g}, f32 "
                      f"{FMT.PLAIN_F32_REL}); worst rel {worst[0]:.3e}")
            if B == TRAIN_B:
                train["calls"] = calls
            del calls
    run.phase("training kernels vs plain versions", check_train_kernels)

    def train_path():
        tnet = train["net"]
        tnet.load_state_dict(train["init"])
        X, Y, SW = train_batch(TRAIN_B, SEED + 500)
        gen = ArrayBatcher(X.cpu().numpy(), Y.cpu().numpy(), TRAIN_B,
                           n_classes=CLASSES)
        tr = Trainer(tnet, epochs=TRAIN_STEPS, compute_dtype=torch.bfloat16,
                     freeze_before=None, verbose=1)
        zero_counts()
        hist = tr.fit(tnet, gen, gen)
        got = counts()
        want = {k: 0 for k in got}
        want.update({"train_" + n: TRAIN_PER_STEP * TRAIN_STEPS
                     for n in FMT.PHASES})
        train["launches"] = got
        print(f"  {TRAIN_STEPS} steps at B={TRAIN_B}: launches {got} "
              f"(want {want})")
        assert got == want, (got, want)
        loss = hist["loss"]
        drop = 1 - loss[-1] / loss[0]
        print(f"  loss by step {[round(v, 5) for v in loss]}: fell "
              f"{drop:.4f} (floor {TRAIN_LOSS_DROP}); val_loss (float32) "
              f"{[round(v, 5) for v in hist['val_loss']]}")
        assert drop >= TRAIN_LOSS_DROP
        assert all(math.isfinite(v) for vs in hist.values() for v in vs)

        # one step with the kernels against the same step with each phase's
        # plain version in its kernel's place
        snap = {k: v.clone() for k, v in tnet.state_dict().items()}

        def one_step(plain):
            tnet.load_state_dict(snap)
            t = Trainer(tnet, compute_dtype=torch.bfloat16, verbose=0,
                        seed=SEED)
            t.setup(tnet)
            saved = counts()
            if plain:
                with FMT.plain_versions():
                    m = t.train_step(X, Y, SW)
            else:
                m = t.train_step(X, Y, SW)
            set_counts(saved)
            grads = {n: p.grad.float().clone()
                     for n, p in tnet.named_parameters()}
            bufs = {n: b.clone() for n, b in tnet.named_buffers()}
            return m["loss"].item(), grads, bufs
        lk, gk, bk = one_step(False)
        lp, gp, bp = one_step(True)
        tnet.fuse_blocks = False
        lc, gc, _ = one_step(False)
        tnet.fuse_blocks = True
        tnet.load_state_dict(snap)

        def spread(g):
            r = sorted(((g[n] - gp[n]).norm()
                        / gp[n].norm().clamp_min(1e-30)).item() for n in gp)
            return {"median": r[len(r) // 2], "p90": r[int(0.9 * len(r))],
                    "worst": r[-1]}
        sk, sc = spread(gk), spread(gc)
        loss_rel = abs(lk - lp) / abs(lp)
        bn_rel = max(((bk[n] - bp[n]).abs().max()
                      / bp[n].abs().max().clamp_min(1e-30)).item()
                     for n in bp)
        head = {n: round(((gk[n] - gp[n]).norm() / gp[n].norm()).item(), 6)
                for n in gp if n.startswith(("conv_upsample", "concat_proj"))}
        print(f"  kernel step vs plain-version step (B={TRAIN_B}): loss "
              f"{lk:.6f} vs {lp:.6f} (rel {loss_rel:.3e}, tol "
              f"{TRAIN_LOSS_REL}); BN moving statistics rel {bn_rel:.3e} (tol "
              f"{TRAIN_BN_REL}); gradient norm-relative error over "
              f"{len(gp)} parameters {sk}; the plain bf16 layer composition "
              f"(loss {lc:.6f}) against the same step: {sc} (the kernel "
              f"step may stray no further); head layers {head}")
        assert loss_rel <= TRAIN_LOSS_REL and bn_rel <= TRAIN_BN_REL
        assert all(sk[k] <= sc[k] for k in sk), (sk, sc)

        pred = Predictor(tnet, compute_dtype="mixed")
        m = pred(X[:1].cpu().numpy())
        assert m.shape == (1, SIZE, SIZE) and m.dtype == np.int32
        assert m.min() >= 0 and m.max() < CLASSES
        agree = float((m.reshape(-1) == Y[0, :, 0].cpu().numpy()).mean())
        print(f"  the trained net served one request through "
              f"Predictor(mixed): {len(np.unique(m))} classes, agreement "
              f"with its training labels {agree:.4f}")
        train["batch"] = (X, Y, SW)
    run.phase("training path: Trainer(bf16).fit, 6 steps at B=16", train_path)

    def train_times():
        calls = train["calls"]
        saved = counts()
        for name in FMT.PHASES:
            kernel = getattr(FMT, name)
            ref = getattr(FMT, name + "_reference")
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
            by = {"bytes": 0.0, "operations": 0.0}
            for args, kw, want in calls[name]:
                with torch.no_grad():
                    ms = cuda_ms(lambda: kernel(*args, **kw), 10)
                    plain = cuda_ms(lambda: ref(*args, **kw), 2, warmup=1)
                bms, bb = train_bound_ms(name, args, want)
                tot["ms"] += ms
                tot["plain_ms"] += plain
                tot["bound_ms"] += bms
                by[bb] += bms
                print(f"  {name:4s} {label(args)}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms, bound {bms:.4f} ms ({bb}), "
                      f"{bms / ms:.3f} of bound [{card}]")
            train_report[name].update(tot)
            train_report[name]["bound_by"] = max(by, key=by.get)
            print(f"  {name} per step (14 launches, B={TRAIN_B}): kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
                  f"{tot['bound_ms']:.4f} ms [{card}]")
        del train["calls"]

        tnet = train["net"]
        X, Y, SW = train["batch"]
        for what, fuse, dt in (("bf16, block kernels", True, torch.bfloat16),
                               ("bf16, plain layer composition", False,
                                torch.bfloat16),
                               ("float32", False, torch.float32)):
            tnet.fuse_blocks = fuse
            t = Trainer(tnet, compute_dtype=dt, verbose=0)
            t.setup(tnet)
            t.train_step(X, Y, SW)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: t.train_step(X, Y, SW), 5, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"  train step {what} B={TRAIN_B}: {ms:.3f} ms/step, "
                  f"{1e3 * TRAIN_B / ms:.1f} img/s, peak device memory "
                  f"{peak:.2f} GiB [{card}]")
        tnet.fuse_blocks = True
        t = Trainer(tnet, compute_dtype=torch.bfloat16, verbose=0)
        t.setup(tnet)
        t.train_step(X, Y, SW)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pr:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                t.train_step(X, Y, SW)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 2
        rows = [(e.key, e.self_device_time_total / 2e3, e.count // 2)
                for e in pr.key_averages()
                if e.self_device_time_total > 0
                and str(e.device_type).endswith("CUDA")]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        print(f"  bf16 train step B={TRAIN_B} under torch.profiler: device "
              f"busy {busy:.3f} ms of {wall:.3f} ms wall (idle share "
              f"{1 - busy / wall:.3f}) [{card}]")
        for key, ms_, n in rows[:15]:
            print(f"    {ms_:8.4f} ms  x{n:<3d} {key[:90]}")
        set_counts(saved)

    # 6. times -----------------------------------------------------------
    def times():
        gen = torch.Generator().manual_seed(SEED + 4)
        pol = core.resolve_compute_dtype("mixed")
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        bound_by = {"bytes": 0.0, "operations": 0.0}
        for ids, cin, ce, cout, rate, skip, st in shapes:
            H = W = SIZE // st
            x, w, mxu = block_inputs(ids, cin, H, W, SERVE_B, pol, gen)
            counted = FM.fused_mbconv.launches
            ms = cuda_ms(lambda: FM.fused_mbconv(
                x, *w, rate=rate, skip=skip, mxu_bf16=mxu), 20)
            FM.fused_mbconv.launches = counted  # timing launches do not count
            plain = cuda_ms(lambda: FM.fused_mbconv_reference(
                x, *w, rate=rate, skip=skip, mxu_bf16=mxu), 10)
            bms, by = bound_ms(SERVE_B, H, W, cin, ce, cout, 4)
            n = len(ids)
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain
            tot["bound_ms"] += n * bms
            bound_by[by] += n * bms
            print(f"  fused_mbconv blocks {ids} {cin}->{ce}->{cout} rate "
                  f"{rate} B={SERVE_B} {H}x{W} f32 io: kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
                  f"{bms / ms:.3f} of bound [{card}]")
        print(f"  per forward (14 launches, B={SERVE_B}): kernel "
              f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms [{card}]")
        kernel_report.update(tot)
        kernel_report["bound_by"] = max(bound_by, key=bound_by.get)

        img = (torch.rand((BENCH_B, SIZE, SIZE, 3), generator=gen) * 255
               ).to(dev)
        for policy in ("mixed", "float32"):
            counted = FM.fused_mbconv.launches
            ms = cuda_ms(lambda: net.predict_ids(img, policy), 10, warmup=2)
            FM.fused_mbconv.launches = counted
            print(f"  model-only {policy} B={BENCH_B}: {ms:.3f} ms/batch, "
                  f"{1e3 * BENCH_B / ms:.1f} img/s [{card}]")
        pred = Predictor(net, compute_dtype="mixed")
        one = (torch.rand((1, SIZE, SIZE, 3), generator=gen) * 255).numpy()
        counted = FM.fused_mbconv.launches
        for _ in range(5):
            pred(one)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred(one)            # returns numpy: includes the device sync
            lat.append(1e3 * (time.perf_counter() - t0))
        FM.fused_mbconv.launches = counted
        print(f"  B=1 latency, Predictor(mixed), host clock incl. copies: "
              f"median {sorted(lat)[len(lat) // 2]:.3f} ms, min "
              f"{min(lat):.3f} ms [{card}]")
    run.phase("times", times)

    def crf_times():
        if not crf_b8:
            raise RuntimeError("no B=8 CRF calls recorded (phase 2 failed)")
        # launch kinds per request: (call index, launches of that kind)
        kinds = {"splat_planes": [(0, 1), (1, 5)],
                 "slice_attrs_planes": [(0, 1)],
                 "gaussian_blur_planes": [(0, 5)],
                 "mf_step_planes": [(0, 4), (-1, 1)]}
        saved = counts()
        for name, ks in kinds.items():
            kernel = getattr(CK, name)
            ref = getattr(CK, name + "_reference")
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
            by = {"bytes": 0.0, "operations": 0.0}
            for idx, n in ks:
                args, kw, out = crf_b8[name][idx]
                with torch.inference_mode():
                    ms = cuda_ms(lambda: kernel(*args, **kw), 20)
                    plain = cuda_ms(lambda: ref(*args, **kw), 3, warmup=1)
                bms, bb = crf_bound_ms(CK, name, args, kw, out)
                tot["ms"] += n * ms
                tot["plain_ms"] += n * plain
                tot["bound_ms"] += n * bms
                by[bb] += n * bms
                shapes = [tuple(t.shape) for t in tensors(args)]
                print(f"  {name} launch {idx} (x{n} per request) inputs "
                      f"{shapes}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                      f"bound {bms:.4f} ms ({bb}), {bms / ms:.3f} of bound "
                      f"[{card}]")
            crf_report[name].update(tot)
            crf_report[name]["bound_by"] = max(by, key=by.get)
            crf_report[name]["library_ms"] = None
            print(f"  {name} per request (B={SERVE_B}): kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
                  f"{tot['bound_ms']:.4f} ms [{card}]")
        # yardstick for the blur: one depthwise conv with the 17x17
        # outer-product kernel over the image-layout tensor (not used by
        # the port)
        import torch.nn.functional as F
        args, kw, _ = crf_b8["gaussian_blur_planes"][0]
        t = torch.tensor(kw["taps"], device=dev).to(torch.bfloat16)
        k2 = (t[:, None].float() * t[None, :].float()).to(torch.bfloat16)
        x = torch.rand((SERVE_B, CLASSES, SIZE, SIZE), device=dev).to(
            torch.bfloat16)
        wgt = k2.expand(CLASSES, 1, *k2.shape).contiguous()
        pad = len(kw["taps"]) // 2
        with torch.inference_mode():
            lib = cuda_ms(lambda: F.conv2d(x, wgt, padding=pad,
                                           groups=CLASSES), 10)
        crf_report["gaussian_blur_planes"]["library_ms"] = 5 * lib
        print(f"  library yardstick for the blur: F.conv2d groups={CLASSES} "
              f"17x17 bf16 on ({SERVE_B}, {CLASSES}, {SIZE}, {SIZE}): "
              f"{lib:.4f} ms per launch, {5 * lib:.4f} ms per request "
              f"[{card}]")

        cfg = CRF.PRODUCTION_CONFIG
        img8, m8 = scene_batch(SERVE_B, SEED + 200, dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: CRF.mean_field_batched(img8, m8, cfg,
                                                        CLASSES), 10,
                         warmup=2)
        print(f"  CRF alone (mean_field_batched, PRODUCTION_CONFIG) B="
              f"{SERVE_B}: {ms:.3f} ms/batch, {1e3 * SERVE_B / ms:.1f} img/s "
              f"[{card}]")
        # where the CRF's device time goes: torch.profiler over 3 calls
        from torch.profiler import ProfilerActivity, profile
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            t0 = time.perf_counter()
            for _ in range(3):
                CRF.mean_field_batched(img8, m8, cfg, CLASSES)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 3
        # kernel rows only: an aten op's row repeats its kernels' time
        rows = [(e.key, e.self_device_time_total / 3e3, e.count // 3)
                for e in pr.key_averages()
                if e.self_device_time_total > 0
                and str(e.device_type).endswith("CUDA")]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        print(f"  CRF B={SERVE_B} per call under torch.profiler: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall (idle share "
              f"{1 - busy / wall:.3f}) [{card}]")
        for key, ms_, n in rows[:12]:
            print(f"    {ms_:8.4f} ms  x{n:<3d} {key[:90]}")
        img16 = scene_batch(BENCH_B, SEED + 300, dev)[0]

        def production():
            ids = net.predict_ids(img16, "mixed")
            return CRF.mean_field_batched(img16, ids, cfg, CLASSES)
        with torch.inference_mode():
            ms = cuda_ms(production, 5, warmup=2)
        print(f"  production end to end (model mixed + CRF) B={BENCH_B}: "
              f"{ms:.3f} ms/batch, {1e3 * BENCH_B / ms:.1f} img/s [{card}]")
        pred = Predictor(net, crf=cfg, compute_dtype="mixed")
        one = img16[:1].cpu().numpy()
        for _ in range(5):
            pred(one)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred(one)            # returns numpy: includes the device sync
            lat.append(1e3 * (time.perf_counter() - t0))
        print(f"  B=1 latency, Predictor(crf=PRODUCTION_CONFIG, mixed), host "
              f"clock incl. copies: median {sorted(lat)[len(lat) // 2]:.3f} "
              f"ms, min {min(lat):.3f} ms [{card}]")
        set_counts(saved)
    run.phase("CRF times", crf_times)
    run.phase("training times", train_times)

    if run.failed:
        print(f"FAILED phases: {run.failed}")
        return 1
    # launches: from the main path's run; times: per request at B=8
    launches = crf_report["launches"]
    line = [{
        "name": "fused_mbconv", "route": "cuda",
        "source": "deeplab_tpu_torch/kernels/csrc/fused_mbconv.cu",
        "replaces": "deeplab_tpu/kernels/fused_mbconv.py:121",
        "launches": launches["fused_mbconv"],
        "max_abs_err": kernel_report["max_abs_err"],
        "ms": kernel_report["ms"], "plain_ms": kernel_report["plain_ms"],
        "bound_ms": kernel_report["bound_ms"],
        "bound_by": kernel_report["bound_by"], "library_ms": None}]
    for n in CK.KERNELS:
        rep = crf_report[n]
        line.append({
            "name": n, "route": "cuda",
            "source": "deeplab_tpu_torch/kernels/csrc/crf_fused.cu",
            "replaces": f"deeplab_tpu/kernels/crf_fused.py:{CRF_REPLACES[n]}",
            "launches": launches[n], "max_abs_err": rep["max_abs_err"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"]})
    # training phases: launches from the training run, times per step at B=16
    for n in FMT.PHASES:
        rep = train_report[n]
        line.append({
            "name": f"block_train_{n}", "route": "cuda",
            "source": "deeplab_tpu_torch/kernels/csrc/fused_mbconv_train.cu",
            "replaces": "deeplab_tpu/kernels/fused_mbconv_train.py:"
                        f"{FMT.REPLACES[n]}",
            "launches": train["launches"]["train_" + n],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
