#!/usr/bin/env python3
"""Drive the PyTorch port (deeplab_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):

1. build every CUDA kernel of the main path from ``deeplab_tpu_torch/kernels/
   csrc`` with nvcc (all sources at once);
2. hold each kernel against its plain PyTorch version at every distinct
   shape the main path gives it, under "mixed" (f32 in/out) and bf16 at
   B=2, and under "mixed" at the served batch;
3. the main path: ``Predictor(SegNet(512x512, 21 classes), "mixed")`` at full
   MobileNetV2 width with seeded weights serves 3 requests of 8 images; the
   kernel's launch count must rise by exactly 14 per forward; the logits are
   compared with the same forward with the plain version in each kernel's
   place, and with the plain layer composition, on the card; and the float32
   port on the card with the float32 port on the CPU;
4. times with CUDA events after warm-up: each kernel launch at the main
   path's shapes beside its bound and its plain version, model-only img/s at
   B=16 under "mixed" and float32, and B=1 latency.

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
    from deeplab_tpu_torch.kernels import build
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    from deeplab_tpu_torch.models import mobilenetv2 as M
    from deeplab_tpu_torch import core

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    run = Run()
    kernel_report = {}

    # 1. build --------------------------------------------------------------
    def do_build():
        t0 = time.perf_counter()
        logs = build.build(["fused_mbconv"])
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

    # 3. the main path ---------------------------------------------------
    def serve():
        gen = torch.Generator().manual_seed(SEED + 3)
        reqs = [(torch.rand((SERVE_B, SIZE, SIZE, 3), generator=gen) * 255)
                .numpy() for _ in range(N_REQUESTS)]
        pred = Predictor(net, compute_dtype="mixed")
        FM.fused_mbconv.launches = 0
        masks = [pred(r) for r in reqs]
        launches = FM.fused_mbconv.launches
        kernel_report["launches"] = launches
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
    run.phase("main path: Predictor(mixed) serving", serve)

    # 4. times -----------------------------------------------------------
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

    if run.failed:
        print(f"FAILED phases: {run.failed}")
        return 1
    print(json.dumps({"kernels": [{
        "name": "fused_mbconv", "route": "cuda",
        "source": "deeplab_tpu_torch/kernels/csrc/fused_mbconv.cu",
        "replaces": "deeplab_tpu/kernels/fused_mbconv.py:121",
        "launches": kernel_report["launches"],
        "max_abs_err": kernel_report["max_abs_err"],
        "ms": kernel_report["ms"], "plain_ms": kernel_report["plain_ms"],
        "bound_ms": kernel_report["bound_ms"],
        "bound_by": kernel_report["bound_by"], "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
