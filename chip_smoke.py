#!/usr/bin/env python3
"""Drive the PyTorch port (deeplab_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):

1. build every CUDA kernel of the main path from ``deeplab_tpu_torch/kernels/
   csrc`` with nvcc (all sources at once), and print each kernel's
   registers, static shared memory, stack and spills from the ``-Xptxas -v``
   log;
2. hold each kernel against its plain PyTorch version: ``fused_mbconv`` at
   every distinct shape the main path gives it, under "mixed" (f32 in/out)
   and bf16 at B=2, and under "mixed" at the served batch; the four CRF
   kernels on every call of a CRF run over seeded 512x512 scenes, at
   ``PRODUCTION_CONFIG`` with B=2 and B=8 and at ``FAST_FAITHFUL_CONFIG``
   and ``THROUGHPUT_CONFIG`` with B=2, the row blur also equal bit for bit
   to the chained y and x plain passes, the fused step to its two-kernel
   form;
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
5. the Xception path: ``fused_sepconv`` against its plain version at every
   distinct shape of the output-stride-16 512x512 net, under "mixed" and
   bf16 at B=2 and "mixed" at B=8;
   ``Predictor(SegNet(512x512, 21, "xception", OS=16), "mixed")`` with
   seeded weights serves 3 requests of 8 images: ``fused_sepconv``'s count
   must rise by exactly 65 per forward and no other kernel's; the logits
   are compared with the same forward with the plain version in the
   kernel's place, with the plain layer composition and with float32; one
   request through ``Predictor(..., crf=PRODUCTION_CONFIG)`` (sepconv 65,
   splat 6, slice_attrs 1, blur 5, mf_step 5); then
   ``Predictor(SegNet(512x512, 21, "mobilenetv2", "subpixel"), "mixed")``
   serves one request of 8 (``fused_mbconv`` 14), its logits against the
   plain-version forward; then, with CUDA events, ``fused_sepconv`` per
   Xception forward at B=8 (each launch shape beside its bound and plain
   version) and the Xception net's model-only img/s at B=16 under "mixed"
   with the kernel, through the plain composition, and in float32;
6. training: the five phase kernels of the training MBConv block
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
7. times with CUDA events after warm-up: each kernel launch at the main
   path's shapes beside its bound and its plain version (``fused_mbconv``
   also beside the plain layer composition, three cuDNN convs with the BN
   folded, and with its launch plan; the blur beside one depthwise
   ``F.conv2d``), the splat (norm pass and iteration) and the step per
   launch on structured, flat and noise 512x512 scenes and on 375x500 ones,
   events and device time beside their bounds (the step also in its
   two-kernel form), model-only img/s at B=16 under "mixed" (with the
   kernels and through the plain layer composition) and float32, the CRF
   alone at B=8, production end to end at B=16, and B=1
   latency with and without the CRF; each training phase per launch and per
   step beside its bound and plain version, the train step's img/s at B=16
   (bf16 with the kernels, bf16 through the plain layer composition, and
   float32) with its peak device memory, and a ``torch.profiler`` table of
   the bf16 step;
8. the evaluation slice: ``fused_dw_bn_relu6`` (MobileNetV2 block 0, one
   launch per forward beside the 14 ``fused_mbconv``) equal bit for bit to
   its plain version at block 0's maps of 512x512, 384x384, 640x640 and
   375x500 requests, 64x64x384 at rate 2, a C that is not a multiple of 4
   and a ragged map, under "mixed" and bf16; ``slice_planes`` and the f32
   splat against their plain
   versions on every call of the XLA engine's 512x512 ``mean_field`` at
   ``FAITHFUL_CONFIG`` and ``PRODUCTION_CONFIG``; the notebook CRF:
   ``do_crf`` per 512x512 image with 2, 5 and 21 sparse label ids,
   ``zero_unsure`` both ways, on the plane engine (6 splat, 1 slice_attrs,
   5 blur, 5 explicit-unary mf_step per image; every step call held to its
   plain version) and the XLA engine (6 splat, 6 slice_planes), masks
   against the plain versions' and the oracle goldens; then the slice's main
   path, ``viz.calculate_iou`` over 4 batches of 8 seeded 512x512 scenes
   through ``Predictor(net, crf=PRODUCTION_CONFIG)`` (per batch 1 + 14 +
   6/1/5/5 launches), against the same run with every plain version in its
   kernel's place; times of both new kernels beside their bounds, block 0
   through the layer composition, ``do_crf`` ms per image on each engine and
   the evaluation loop's ms per image;
9. the rest of the CRF: the spatial blur's y and x kernels against their
   plain versions, bit for bit, launched directly at the VOC cell heights
   75, 50 and 72 (r = 8), radii 20 and 32 on 64x128 cells, a ragged L and
   both forms of gn, and the row kernel at the VOC heights bit for bit
   against the chained plain passes; every blur call of the runs below
   against its plain version; ``mean_field_batched`` at
   ``PRODUCTION_CONFIG`` on seeded (8, 375, 500) and (8, 500, 375) scenes
   (per run splat 6, slice_attrs 1, row blur 5, y 0, x 0, mf_step 5: the
   VOC cells take the row kernel) and ``do_crf`` at ``CrfConfig()`` on
   375x500 and 500x375 scenes with 2, 5 and 21 labels, each against the
   same run with the plain versions;
   ``Predictor(net, crf=PRODUCTION_CONFIG at resolution_scale 2, "mixed")``
   serving 3 requests of 8 (per request 1 + 14 model launches and the CRF
   6 / 1 / 5 with no blur kernel: its 32x40 cells take the image-layout
   blur), ``do_crf`` on the XLA engine at ``resolution_scale`` 2 and the
   oracle golden of tests/test_crf_pallas.py's resolution_scale test (floor
   0.90); the notebook's ``CrfConfig(sxy_bilateral=16)`` and
   ``CrfConfig(sxy_gaussian=8)`` through ``do_crf`` at 512x512 (the latter,
   r = 20, runs the y and x passes: 5 each); then, with CUDA events, the
   row kernel on a (8, 375, 500) batch's blur input and each pass launched
   directly on the same input, each beside its bound, its plain version and
   one depthwise ``F.conv2d``, the passes also at r = 20 on (8, 512, 512)
   in 64x128 cells, ``mean_field_batched`` per (8, 375, 500) batch, and
   production end to end at ``resolution_scale`` 2, B=16;
10. the serving surface: ``Predictor(net, crf=PRODUCTION_CONFIG, "mixed",
   tta_scales=(0.75, 1.0, 1.25), tta_flip=True)`` serves 2 requests of 8
   (seeded scenes, then seeded noise; per request fused_dw 6, fused_mbconv
   84, splat 6, slice_attrs 1, blur 5, mf_step 5), its raw and refined
   labels against the same run with every plain version in its kernel's
   place; one Xception TTA request (fused_sepconv 390);
   ``serve._Dispatcher`` over
   ``Predictor(net, crf=PRODUCTION_CONFIG, "mixed")`` (max_batch 16,
   max_wait 5 ms) takes 128 requests from 32 client threads: exact launch
   counts per device call, the model on the dispatcher's thread only, in
   inference mode, on that thread's current stream, each mask against a
   direct call on its image, the histogram of device batch sizes; one round
   trip through ``BatchingServer`` over HTTP where PIL imports; TTA ms per
   B=8 request and the dispatcher's requests/s and p50/p99 latency.

``python3 chip_smoke.py --dw`` holds ``fused_dw_bn_relu6`` bit for bit to
its plain version at phase 8's shapes and times it there (events, device
time in a CUDA graph, beside its bound, its plain version and a copy of x);
public API only, so a copy run from a parent checkout times the parent's
kernel; where ``dw_plan`` exists it also times every strip width and chunk
the plan may choose at block 0's shape.
``python3 chip_smoke.py --plan-sweep`` times instead every tile and chunk
that ``fused_mbconv``'s launch plan may choose at each main-path block shape
(the data its cost model is fitted to) and exits.  ``--crf-scenes`` times
only the splat and the step on those scenes (phase 7's), through the
wrappers' public API: a copy of this file run from the root of another
checkout (a parent commit) times that checkout's kernels, for a comparison
in one call.  ``--train-phases`` does the same for the training block's
five phases: each held to its plain version and timed (CUDA events, and
device time in a CUDA graph) beside its bound at every block shape of the
net at B=16 (F1 and F3 also beside their plain bf16 composition), per
step, with a ``torch.profiler`` split of B2 and B34 by kernel.
``--train-plan-sweep [f1 f2 f3 b34]`` times every tile and chunk that the
halo phases' launch plan (``train_plan``) may choose at those shapes, and
every warpgroup count of F1's and width, column groups and ring of F3's
(only the named phases, where some are named).  B2 and B34 are
also split by kernel there.  ``--sepconv-shapes`` holds ``fused_sepconv``
to its plain version and times it at each launch shape of the Xception net
at B=8, output stride 16 and 8, beside its bound and the cuDNN composition,
with the build's registers and spills (public API only, so a copy run from
a parent checkout times the parent's kernel); ``--sepconv-plan-sweep``
times every chunk and pass width that ``sepconv_plan`` may choose at those
shapes.  ``--train-step`` times only the bf16 train step at B=16 (img/s,
peak memory, device busy share), public API only, for parent and change in
turns.  ``--crf-fallbacks`` times ``slice_planes`` (per launch and per
512x512 XLA-engine image at ``FAITHFUL_CONFIG``), the y and x passes (at
the (8, 375, 500) shapes, r = 8, and on (8, 512, 512) at r = 20), the row
kernel on the VOC input and ``mean_field_batched`` per (8, 375, 500)
batch, public API only, so a copy run from a parent checkout times the
parent's kernels; it prints a digest of ``slice_planes``' outputs on its
seeded inputs, to compare two checkouts bit for bit.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Without
CUDA, or without the port beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
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

# the Xception path: eval-mode stride-1 SepConv_BNs per forward at OS 16
XCEPTION_OS, SEPCONV_PER_FORWARD = 16, 65
# Xception kernel path vs the same forward with the plain version in the
# kernel's place: the per-launch differences of KERNEL_REL_TOL carried
# through 65 layers (as KERNEL_PATH_* for the 14 MBConv blocks).  Against
# float32: the kernel path rounds the BN-folded pointwise weights and the f32
# depthwise output to bf16, the composition rounds the raw weights and both
# convs' inputs; neither is ordered before the other, so the kernel path may
# be at most 1.5x as far from float32 as the composition (max |error|) and
# trail its argmax agreement with float32 by at most F32_AGREE_MARGIN.
SEPCONV_F32_RATIO = 1.5
# The stride-1 SepConv_BN launches of the 512x512 Xception net per forward,
# at output stride 16 and 8: (Cin, Cout, rate, map side, pre_relu) ->
# launches (pre_relu False: depth_activation, ReLU after each BN).
# tests/test_torch_kernel_plans.py holds the same table to the net's calls.
XCEPTION_SHAPES = {
    16: {(64, 128, 1, 256, True): 1, (128, 128, 1, 256, True): 1,
         (128, 256, 1, 128, True): 1, (256, 256, 1, 128, True): 1,
         (256, 728, 1, 64, True): 1, (728, 728, 1, 64, True): 1,
         (728, 728, 1, 32, True): 49, (728, 1024, 1, 32, True): 1,
         (1024, 1024, 1, 32, True): 1, (1024, 1536, 2, 32, False): 1,
         (1536, 1536, 2, 32, False): 1, (1536, 2048, 2, 32, False): 1,
         (2048, 256, 6, 32, False): 1, (2048, 256, 12, 32, False): 1,
         (2048, 256, 18, 32, False): 1, (304, 256, 1, 128, False): 1,
         (256, 256, 1, 128, False): 1},
    8: {(64, 128, 1, 256, True): 1, (128, 128, 1, 256, True): 1,
        (128, 256, 1, 128, True): 1, (256, 256, 1, 128, True): 1,
        (256, 728, 1, 64, True): 1, (728, 728, 1, 64, True): 2,
        (728, 728, 2, 64, True): 49, (728, 1024, 2, 64, True): 1,
        (1024, 1024, 2, 64, True): 1, (1024, 1536, 4, 64, False): 1,
        (1536, 1536, 4, 64, False): 1, (1536, 2048, 4, 64, False): 1,
        (2048, 256, 12, 64, False): 1, (2048, 256, 24, 64, False): 1,
        (2048, 256, 36, 64, False): 1, (304, 256, 1, 128, False): 1,
        (256, 256, 1, 128, False): 1}}

CRF_PER_REQUEST = {"splat_planes": 6, "slice_attrs_planes": 1,
                   "gaussian_blur_planes": 5, "mf_step_planes": 5}
# the XLA engine per image: the norm pass and 5 iterations
XLA_PER_IMAGE = {"splat_planes": 6, "slice_planes": 6}
# the TPU kernels they replace (file:line of the pl.pallas_call)
CRF_REPLACES = {"splat_planes": 702, "slice_attrs_planes": 890,
                "gaussian_blur_planes": 568, "mf_step_planes": 988,
                "slice_planes": 731, "gaussian_blur_y_planes": 628,
                "gaussian_blur_x_planes": 638}
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

# fused_dw_bn_relu6 against its plain version: both sum the 9 taps in f32
# in the same order with the same roundings and must agree bit for bit;
# the relative bounds, printed beside, are those of a summation-order
# difference (f32 outputs) and one flipped bf16 rounding (bf16, 2 ulps)
DW_REL_TOL = {"mixed": 1e-5, "bfloat16": 2 * 2.0 ** -8}
# rows a block that ``--dw`` forces at block 0's shape
DW_SWEEP_ROWS = (8, 16, 32, 48, 64, 96, 128)
# (B, H, W, C, rate) at which fused_dw_bn_relu6 must equal its plain
# version bit for bit: block 0 of the served batch at 512x512 and at the
# test-time augmentation's 384x384 and 640x640, at VOC's 375x500, the JAX
# kernel's documented shape, a C that is not a multiple of 4, a ragged map
DW_SHAPES = ((SERVE_B, 256, 256, 32, 1), (SERVE_B, 192, 192, 32, 1),
             (SERVE_B, 320, 320, 32, 1), (SERVE_B, 188, 250, 32, 1),
             (SERVE_B, 64, 64, 384, 2), (2, 20, 36, 7, 1),
             (2, 37, 53, 24, 4))
# the serving surface: test-time augmentation at 384, 512 and 640 (the
# twins' block-0 maps 192, 256, 320), with flips, through the production
# CRF: per request 6 forwards of 1 + 14 model launches and one CRF run; the
# Xception net's 6 forwards of 65 fused_sepconv launches
TTA_SCALES, TTA_REQUESTS = (0.75, 1.0, 1.25), 2
TTA_PER_REQUEST = {"fused_dw_bn_relu6": 6, "fused_mbconv": 84,
                   "splat_planes": 6, "slice_attrs_planes": 1,
                   "gaussian_blur_planes": 5, "mf_step_planes": 5}
TTA_XCEPTION_SEPCONV = 390
# the dispatcher under load: requests from client threads, its gather
# limits, and each mask against a direct Predictor call on its image
# (a different batch composition: cuDNN may choose other algorithms)
DISPATCH_CLIENTS, DISPATCH_REQUESTS = 32, 128
DISPATCH_MAX_BATCH, DISPATCH_WAIT_MS, DISPATCH_FLOOR = 16, 5.0, 0.99
# the notebook CRF: label counts of the 512x512 do_crf scenes; the oracle
# floors of tests/test_crf_goldens.py for do_crf at CrfConfig() and
# FAST_FAITHFUL_CONFIG (the latter is CRF_PATH_FLOOR's neighbour above)
DO_CRF_LABELS, GOLDEN_DEFAULT_FLOOR = (2, 5, 21), 0.97
EVAL_BATCHES = 4
EVAL_MEAN_TOL = 0.01
# the rest of the CRF: VOC image sizes (their cell heights 75 and 50 take
# the row kernel), per run of the plane engine
VOC_SIZES = ((375, 500), (500, 375))
VOC_PER_RUN = {"splat_planes": 6, "slice_attrs_planes": 1,
               "gaussian_blur_planes": 5, "mf_step_planes": 5}
# resolution_scale 2 at 512x512: 32x40 cells, the image-layout blur
RS2_PER_REQUEST = {"splat_planes": 6, "slice_attrs_planes": 1,
                   "mf_step_planes": 5}
# the oracle floor of tests/test_crf_pallas.py::test_resolution_scale_quality
RS2_GOLDEN_FLOOR = 0.90
# the y and x kernels against their plain versions: (B, ny, nx, cs_y, cs_x,
# L, sigma, gn per image); sigma 8 and 12.5 give radii 20 and 32; where the
# row kernel takes the shape (r = 8, gn (Z, 1, P)) it is held to the
# chained plain passes too
BLUR_PASS_SHAPES = ((SERVE_B, 5, 4, 75, 128, 21, 3.0, False),
                    (SERVE_B, 10, 3, 50, 128, 21, 3.0, True),
                    (SERVE_B, 10, 3, 50, 128, 21, 3.0, False),
                    (SERVE_B, 5, 4, 72, 128, 21, 3.0, False),
                    (SERVE_B, 8, 4, 64, 128, 21, 8.0, False),
                    (SERVE_B, 8, 4, 64, 128, 21, 12.5, True),
                    (2, 5, 4, 75, 128, 7, 3.0, True))

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's launch path is not timed (events
    around back-to-back launches, ``cuda_ms``, include it where a launch
    takes less device time than its Python wrapper takes on the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def ptxas_table(log: str):
    """(kernel, "registers, static shared memory, stack, spills") for each
    entry function of an ``nvcc -Xptxas -v`` log, names demangled where
    c++filt is on the PATH."""
    import re
    rows, name, props = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, props = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                     f"spill loads {m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            rows.append((name, f"{m.group(1)} registers, static smem "
                         f"{smem.group(1) if smem else 0} B, {props}"))
            name = None
    if rows:
        try:
            out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                                 capture_output=True, text=True, timeout=30)
            names = out.stdout.splitlines()
            if out.returncode == 0 and len(names) == len(rows):
                rows = [(n.replace("(anonymous namespace)::", ""), i)
                        for n, (_, i) in zip(names, rows)]
        except (OSError, subprocess.SubprocessError):
            pass
    return rows


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
    grid value, 2 x 17 taps per blurred value; 17 taps a pass for the y and
    x passes, and the y pass's gn multiply)."""
    rows_read = {"splat_planes": 4, "mf_step_planes": CK.ATTR_ROWS - 1}
    nbytes = sum(t.numel() * t.element_size()
                 for t in tensors(args[1:]) + tensors(kw) + tensors(out))
    first = args[0]
    share = (rows_read[name] / CK.ATTR_ROWS if name in rows_read
             and first.shape[1] == CK.ATTR_ROWS else 1)
    nbytes += first.numel() * first.element_size() * share
    if name == "gaussian_blur_planes":
        ops = 2 * (2 * len(kw["taps"]) + 1) * out.numel()
    elif name == "gaussian_blur_y_planes":     # the taps and the gn multiply
        ops = (2 * len(kw["taps"]) + 1) * out.numel()
    elif name == "gaussian_blur_x_planes":
        ops = 2 * len(kw["taps"]) * out.numel()
    else:
        # (pixel, label) pairs: the values splatted, or the Q sliced
        if name == "splat_planes":
            n_pl = args[1].numel()
        else:
            n_pl = tensors(out)[1 if name == "slice_attrs_planes"
                                else 0].numel()
        ops = 2 * 8 * n_pl
        if name != "splat_planes":
            nt = len(kw["ctaps"])
            grid = args[1]
            ops += 2 * 2 * n_pl + 2 * (nt * nt + nt) * grid.numel()
        if name == "mf_step_planes":
            ops += 20 * n_pl                  # messages, unary, softmax
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def seeded_net(image_size, seed, device, backbone="mobilenetv2",
               head="original", OS=16, var_floor=1e-3):
    """Full-width SegNet with seeded weights and non-trivial BN statistics.
    Glorot weights alone shrink the signal through 60 layers, so each BN
    takes its moving statistics from its own input on one seeded batch
    (layer by layer, in one forward), the variance times a seeded jitter
    plus ``var_floor``, and seeded gamma/beta: every layer then carries
    activations of order 1.  The Xception net takes a floor of 0.1: its
    SepConvs ReLU their input, channels that are nearly constant on the
    batch are common, and a BN that scales one up by 1/sqrt(1e-3) through
    65 such layers turns bf16 rounding into O(1) differences between any two
    correct paths (measured: two paths that differ only in summation order
    disagreed on 16% of the argmax)."""
    from deeplab_tpu_torch import SegNet
    from deeplab_tpu_torch.ops.bn import BatchNorm
    net = SegNet(image_size, CLASSES, backbone, head, OS=OS, seed=seed,
                 fuse_blocks=False)
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
                                 * jitter[bn].to(x.device) + var_floor)

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


def mbconv_composition(x, w, rate, skip):
    """The fused block as the plain layer composition under "mixed", its
    yardstick: three cuDNN convs in bf16 with the folded BN as their bias
    (1x1 expand, 3x3 depthwise at the rate, 1x1 project), relu6 between,
    the residual added in f32.  x (B, H, W, Cin) f32; returns a callable."""
    import torch.nn.functional as F
    w1, b1, wdw, bdw, w2, b2 = w
    ce = w1.shape[1]
    bf = torch.bfloat16
    k1 = w1.t().contiguous().to(bf)[:, :, None, None]
    kd = wdw.t().reshape(ce, 1, 3, 3).contiguous().to(bf)
    k2 = w2.t().contiguous().to(bf)[:, :, None, None]
    b1, bdw, b2 = b1.to(bf), bdw.to(bf), b2.to(bf)
    xn = x.permute(0, 3, 1, 2)          # channels-last memory

    def run():
        e = F.conv2d(xn.to(bf), k1, b1).clamp_(0.0, 6.0)
        d = F.conv2d(e, kd, bdw, padding=rate, dilation=rate,
                     groups=ce).clamp_(0.0, 6.0)
        o = F.conv2d(d, k2, b2).float()
        return o + xn if skip else o
    return run


def bound_ms(B, H, W, cin, ce, cout, act_bytes):
    px = B * H * W
    bytes_ = (px * (cin + cout) * act_bytes
              + 2 * (cin * ce + ce * cout) + 4 * (11 * ce + cout))
    t_bytes = bytes_ / HBM_BYTES_S
    t_tc = 2 * px * (cin * ce + ce * cout) / BF16_TC_FLOP_S
    t_fp32 = 18 * px * ce / F32_FLOP_S
    t = max(t_bytes, t_tc, t_fp32)
    return 1e3 * t, ("bytes" if t == t_bytes else "operations")


def sepconv_bound_ms(B, H, W, cin, cout, act_bytes):
    """Least time for one fused_sepconv launch: the activations read and
    written once, the folded weights read once, at 3.35 TB/s, against the
    pointwise's 2 px Cin Cout bf16 tensor-core flops at 989 TFLOP/s and the
    depthwise's 18 px Cin f32 flops at 67 TFLOP/s."""
    px = B * H * W
    bytes_ = px * (cin + cout) * act_bytes + 2 * cin * cout + 4 * (10 * cin
                                                                   + cout)
    t_bytes = bytes_ / HBM_BYTES_S
    t = max(t_bytes, 2 * px * cin * cout / BF16_TC_FLOP_S,
            18 * px * cin / F32_FLOP_S)
    return 1e3 * t, ("bytes" if t == t_bytes else "operations")


def sepconv_composition(x, w, rate, pre_relu, act):
    """The fused SepConv_BN as the plain layer composition under "mixed",
    its yardstick: two cuDNN convs in bf16 with the folded BN as their bias
    (the 3x3 depthwise at the rate, grouped, then the 1x1 pointwise), the
    ReLUs where the layer has them, the output in f32.  x (B, H, W, Cin)
    f32; returns a callable."""
    import torch.nn.functional as F
    wdw, bdw, wpw, bpw = w
    cin = wdw.shape[1]
    bf = torch.bfloat16
    kd = wdw.t().reshape(cin, 1, 3, 3).contiguous().to(bf)
    kp = wpw.t().contiguous().to(bf)[:, :, None, None]
    bdw, bpw = bdw.to(bf), bpw.to(bf)
    xn = x.permute(0, 3, 1, 2)          # channels-last memory

    def run():
        v = xn.to(bf)
        if pre_relu:
            v = torch.relu(v)
        d = F.conv2d(v, kd, bdw, padding=rate, dilation=rate, groups=cin)
        if act:
            d = torch.relu(d)
        o = F.conv2d(d, kp, bpw)
        if act:
            o = torch.relu(o)
        return o.float()
    return run


def sepconv_weights(cin, cout, dev, gen):
    """Seeded folded weights of one SepConv_BN: (wdw, bdw, wpw, bpw)."""
    wdw = torch.randn((9, cin), generator=gen, device=dev) * 0.3
    bdw = torch.randn((cin,), generator=gen, device=dev) * 0.1
    wpw = (torch.randn((cin, cout), generator=gen, device=dev)
           * cin ** -0.5).to(torch.bfloat16)
    bpw = torch.randn((cout,), generator=gen, device=dev) * 0.1
    return wdw, bdw, wpw, bpw


def sepconv_shape_times(card) -> dict:
    """``--sepconv-shapes``: ``fused_sepconv`` at each launch shape of the
    512x512 Xception net at B=8, output stride 16 and 8, "mixed", seeded
    weights: held to its plain version (KERNEL_REL_TOL), timed with CUDA
    events and as device time in a CUDA graph, beside its bound and the
    cuDNN composition; per forward (each shape times its launches).  Uses
    only the wrapper's public API, so a copy of this file run from the root
    of a parent checkout times that checkout's kernel.  Returns {OS: per
    forward totals}."""
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED + 21)
    res, bad = {}, []
    for OS, shapes in XCEPTION_SHAPES.items():
        tot = {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0,
               "composition_ms": 0.0}
        for (cin, cout, rate, side, pre), n in shapes.items():
            w = sepconv_weights(cin, cout, dev, gen)
            x = torch.randn((SERVE_B, side, side, cin), generator=gen,
                            device=dev)
            kw = dict(rate=rate, pre_relu=pre, act_mid=not pre,
                      act_out=not pre, mxu_bf16=True)
            with torch.inference_mode():
                got = FM.fused_sepconv(x, *w, **kw)
                ref = FM.fused_sepconv_reference(x, *w, **kw)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                ok = math.isfinite(err) and err <= KERNEL_REL_TOL["mixed"] * scale
                del got, ref
                ms = cuda_ms(lambda: FM.fused_sepconv(x, *w, **kw), 10)
                dev_ms = graph_ms(lambda: FM.fused_sepconv(x, *w, **kw), 5)
                comp = cuda_ms(sepconv_composition(x, w, rate, pre, not pre),
                               10)
            bms, bb = sepconv_bound_ms(SERVE_B, side, side, cin, cout, 4)
            for k, v in (("ms", ms), ("device_ms", dev_ms),
                         ("bound_ms", bms), ("composition_ms", comp)):
                tot[k] += n * v
            if not ok:
                bad.append((OS, cin, cout, rate, side))
            print(f"  OS {OS} {cin}->{cout} rate {rate} {side}x{side} "
                  f"pre_relu {int(pre)} x{n} B={SERVE_B}: kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f}), composition {comp:.4f} ms, bound "
                  f"{bms:.4f} ms ({bb}), {bms / dev_ms:.3f} of bound, rel err "
                  f"{err / max(scale, 1e-30):.2e}"
                  f"{'' if ok else ' FAILS its plain version'} [{card}]",
                  flush=True)
        print(f"  OS {OS} per forward ({sum(shapes.values())} launches, "
              f"B={SERVE_B}): kernel {tot['ms']:.4f} ms (device "
              f"{tot['device_ms']:.4f}), composition "
              f"{tot['composition_ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
              f"ms [{card}]", flush=True)
        res[OS] = tot
    if bad:
        raise AssertionError(f"fused_sepconv disagrees at {bad}")
    return res


def sepconv_plan_sweep(card) -> int:
    """``--sepconv-plan-sweep``: every (chunk, pass width) that
    ``sepconv_plan`` may choose, forced (the plan then picks the Cout
    groups and ring), held to the plain version and timed (device time in
    a CUDA graph) at each Xception launch shape at B=8, "mixed", beside
    the plan's choice and its cost model's estimate: the data the cost
    model is fitted to."""
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED + 22)
    chunks, nts = FM.SEPCONV_CHUNKS, FM.SEPCONV_NT
    bad = []
    seen = set()
    for OS, shapes in XCEPTION_SHAPES.items():
        for (cin, cout, rate, side, pre), n in shapes.items():
            if (cin, cout, rate, side) in seen:
                continue
            seen.add((cin, cout, rate, side))
            w = sepconv_weights(cin, cout, dev, gen)
            x = torch.randn((SERVE_B, side, side, cin), generator=gen,
                            device=dev)
            kw = dict(rate=rate, pre_relu=pre, act_mid=not pre,
                      act_out=not pre, mxu_bf16=True)
            chosen = FM.sepconv_plan(SERVE_B, side, side, cin, cout, rate)
            with torch.inference_mode():
                ref = FM.fused_sepconv_reference(x, *w, **kw)
                scale = ref.abs().max().item()
                for ck in chunks:
                    for nt in nts:
                        FM.SEPCONV_CHUNKS, FM.SEPCONV_NT = (ck,), (nt,)
                        FM.sepconv_plan.cache_clear()
                        try:
                            p = FM.sepconv_plan(SERVE_B, side, side, cin,
                                                cout, rate)
                        except ValueError:
                            continue
                        err = (FM.fused_sepconv(x, *w, **kw) - ref
                               ).abs().max().item()
                        ok = err <= KERNEL_REL_TOL["mixed"] * scale
                        if not ok:
                            bad.append((cin, cout, rate, side, ck, nt))
                        ms = graph_ms(lambda: FM.fused_sepconv(x, *w, **kw),
                                      5)
                        mark = ("  <- plan" if (p.ck, p.nt) == (
                            chosen.ck, chosen.nt) else "")
                        print(f"  {cin}->{cout} rate {rate} {side}x{side}"
                              f" x{n} (OS {OS}): {p.th}x{p.tw} chunk {ck} "
                              f"nt {nt} groups {p.groups} passes {p.passes} "
                              f"stages {p.stages}: {ms:.4f} ms"
                              f"{'' if ok else ' FAILS its plain version'}"
                              f", estimate {p.est_clk:.0f} clk{mark} "
                              f"[{card}]", flush=True)
            FM.SEPCONV_CHUNKS, FM.SEPCONV_NT = chunks, nts
            FM.sepconv_plan.cache_clear()
    print(card)
    return 1 if bad else 0


def dw_bound_ms(x):
    """Least time for one fused_dw_bn_relu6 launch: x read once and the
    output written once (the taps and affine are 11 C floats) at 3.35 TB/s,
    against 20 f32 flops per output (9 multiply-adds and the affine) at 67
    TFLOP/s."""
    nbytes = 2 * x.numel() * x.element_size() + 4 * 11 * x.shape[-1]
    t_b, t_o = nbytes / HBM_BYTES_S, 20 * x.numel() / F32_FLOP_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def dw_inputs(shape, dtype, gen, dev):
    """Seeded (x, taps, scale, shift) of one fused_dw_bn_relu6 launch."""
    B, H, W, C, _ = shape
    x = torch.randn((B, H, W, C), generator=gen, device=dev)
    k = 0.3 * torch.randn((3, 3, C, 1), generator=gen, device=dev)
    scale = 1 + 0.2 * torch.randn(C, generator=gen, device=dev)
    shift = 0.5 * torch.randn(C, generator=gen, device=dev)
    return x.to(dtype), k, scale, shift


def dw_times(card) -> int:
    """``--dw``: ``fused_dw_bn_relu6`` held bit for bit to its plain version
    at every DW_SHAPES entry, f32 and bf16, and timed there (CUDA events,
    and device time in a CUDA graph) beside its bound, its plain version and
    a copy of x (the bytes' yardstick: one read and one write of x).  Public
    API only, so a copy of this file run from a parent checkout times the
    parent's kernel.  Where the checkout has ``dw_plan``, every strip width
    and channel chunk the plan may choose is also forced and timed at block
    0's shape (the data its cost model is judged by).  Returns 1 if a shape
    disagrees."""
    from deeplab_tpu_torch.kernels import build
    from deeplab_tpu_torch.kernels import fused_dw as FDW
    for kern, info in ptxas_table(build.build(["fused_dw"])["fused_dw"]):
        print(f"  [fused_dw] {kern}: {info}")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    plan_of = getattr(FDW, "dw_plan", None)
    bad = 0

    def one(x, k, scale, shift, rate):
        return FDW.fused_dw_bn_relu6(x, k, scale, shift, rate=rate)

    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            for shape in DW_SHAPES:
                rate = shape[-1]
                x, k, scale, shift = dw_inputs(shape, dt, gen, dev)
                got = one(x, k, scale, shift, rate)
                ref = FDW.fused_dw_bn_relu6_reference(x, k, scale, shift,
                                                      rate=rate)
                torch.cuda.synchronize()
                same = torch.equal(got, ref)
                bad += not same
                ms = cuda_ms(lambda: one(x, k, scale, shift, rate), 50)
                dms = graph_ms(lambda: one(x, k, scale, shift, rate))
                plain = cuda_ms(lambda: FDW.fused_dw_bn_relu6_reference(
                    x, k, scale, shift, rate=rate), 5, warmup=1)
                copy = graph_ms(lambda: x.clone())
                bms, bb = dw_bound_ms(x)
                plan = (plan_of(*shape[:4], rate, dt, FDW.dw_vec(
                    shape[3], x.element_size())) if plan_of else None)
                print(f"  dw {str(dt)[6:]:8s} {shape}: "
                      f"{'bit for bit' if same else 'DIFFERS'}; kernel "
                      f"{ms:.4f} ms, device {dms:.4f}, plain {plain:.4f}, "
                      f"copy of x {copy:.4f}, bound {bms:.4f} ({bb}), "
                      f"{bms / dms:.3f} of bound; plan {plan} [{card}]",
                      flush=True)
        if plan_of:
            shape = DW_SHAPES[0]
            B, H, W, C, _ = shape
            for dt in (torch.float32, torch.bfloat16):
                x, k, scale, shift = dw_inputs(shape, dt, gen, dev)
                ref = FDW.fused_dw_bn_relu6_reference(x, k, scale, shift)
                esize = x.element_size()
                vec = FDW.dw_vec(C, esize)
                chosen = plan_of(B, H, W, C, 1, dt, vec)
                mine = (chosen.sw, chosen.cv, chosen.th, chosen.prefetch)
                rows = []
                try:
                    for sw, cv, th, pf in itertools.product(
                            FDW.DW_STRIPS, (16, 8, 4, 2), DW_SWEEP_ROWS,
                            (1, 2, 4)):
                        threads = sw * cv
                        if (cv > C // vec or (C // vec) % cv
                                or not 64 <= threads <= FDW.DW_MAX_THREADS):
                            continue
                        smem = FDW.dw_smem(1, sw, cv, vec, esize, pf)
                        plan = dataclasses.replace(
                            chosen, sw=sw, th=th, cv=cv, prefetch=pf,
                            threads=threads, smem=smem,
                            strips_x=-(-W // sw), strips_y=-(-H // th),
                            chunks=C // vec // cv, est=0.0)
                        FDW.dw_plan = lambda *a, plan=plan, **kw: plan
                        got = one(x, k, scale, shift, 1)
                        same = torch.equal(got, ref)
                        bad += not same
                        dms = graph_ms(lambda: one(x, k, scale, shift, 1))
                        rows.append((dms, sw, cv, th, pf))
                        tag = " (the plan)" if rows[-1][1:] == mine else ""
                        print(f"  dw sweep {shape} {str(dt)[6:]} sw {sw} cv "
                              f"{cv} th {th} prefetch {pf}: device "
                              f"{dms:.4f} ms{'' if same else ' DIFFERS'}"
                              f"{tag}", flush=True)
                finally:
                    FDW.dw_plan = plan_of
                best = min(rows)
                print(f"  dw sweep {str(dt)[6:]}: best {best[0]:.4f} ms at "
                      f"sw {best[1]} cv {best[2]} th {best[3]} prefetch "
                      f"{best[4]}; the plan sw {chosen.sw} cv {chosen.cv} th "
                      f"{chosen.th} prefetch {chosen.prefetch}", flush=True)
    print(card)
    return 1 if bad else 0


def sparse_mask(mask, n_labels, seed):
    """The scene mask's ids 0..n-1 mapped onto n sparse ids in 0..255."""
    import numpy as np
    ids = np.sort(np.random.RandomState(seed).choice(256, n_labels, False))
    return ids[mask]


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


def train_composition(name, args):
    """The plain bf16 composition of training phase F1 or F3 on the card,
    as a model built from library calls would run it: F1 ``torch.matmul``
    of x and w1 in bf16 (cuBLAS rounds the f32 sums once: q), then the sum
    and the sum of squares in f32; F3 the BN2 affine with its two roundings
    and relu6, then ``torch.matmul`` with w2 in bf16.  Returns a callable;
    no single call computes a phase (``library_ms`` stays null)."""
    if name == "f1":
        x, w1 = args
        x2 = x.reshape(-1, x.shape[-1])

        def run():
            e = (x2 @ w1).float()
            return e.sum(0), (e * e).sum(0)
        return run
    dq, a2, c2, w2 = args
    d2 = dq.reshape(-1, dq.shape[-1])

    def run():
        v = ((d2.float() * a2).bfloat16().float() + c2).bfloat16()
        return torch.clamp(v, 0.0, 6.0) @ w2
    return run


def device_table(fn, what, calls=3, top=12):
    """Where ``fn``'s device time goes: ``torch.profiler`` over ``calls``
    calls, the busy share of the wall time and the top kernels per call."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / calls
    # kernel rows only: an aten op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / (1e3 * calls),
             e.count // calls)
            for e in pr.key_averages()
            if e.self_device_time_total > 0
            and str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"  {what} per call under torch.profiler: device busy {busy:.3f} "
          f"ms of {wall:.3f} ms wall (idle share {1 - busy / wall:.3f}) "
          f"[{card_line()}]")
    for key, ms_, n in rows[:top]:
        print(f"    {ms_:8.4f} ms  x{n:<3d} {key[:90]}")


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


def plan_sweep() -> int:
    """``--plan-sweep``: every (tile, chunk) that ``mbconv_plan`` may choose,
    forced, timed at each main-path block shape (B=8, "mixed", seeded
    weights), beside the plan's choice: the data its cost model is fitted
    to.  Times are device times in a CUDA graph."""
    from deeplab_tpu_torch.kernels import build
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    from deeplab_tpu_torch.models import mobilenetv2 as M
    card = card_line()
    build.build(["fused_mbconv"])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    tiles, chunks = FM.MBCONV_TILES, FM.MBCONV_CHUNKS
    for ids, cin, ce, cout, rate, skip, st in fused_shapes(M):
        H = W = SIZE // st
        w = [torch.randn(cin, ce, generator=gen) * 0.2,
             torch.randn(ce, generator=gen) * 0.1,
             torch.randn(9, ce, generator=gen) * 0.2,
             torch.randn(ce, generator=gen) * 0.1,
             torch.randn(ce, cout, generator=gen) * 0.1,
             torch.randn(cout, generator=gen) * 0.1]
        w = [t.to(dev) for t in w]
        w[0], w[4] = w[0].bfloat16(), w[4].bfloat16()
        x = torch.randn((SERVE_B, H, W, cin), generator=gen).to(dev)
        chosen = FM.mbconv_plan(SERVE_B, H, W, cin, ce, cout, rate)
        for tile in tiles:
            for ck in chunks:
                FM.MBCONV_TILES, FM.MBCONV_CHUNKS = (tile,), (ck,)
                FM.mbconv_plan.cache_clear()
                try:
                    p = FM.mbconv_plan(SERVE_B, H, W, cin, ce, cout, rate)
                except ValueError:
                    continue
                ms = graph_ms(lambda: FM.fused_mbconv(
                    x, *w, rate=rate, skip=skip, mxu_bf16=True))
                mark = ("  <- plan" if (p.th, p.tw, p.ck) == (
                    chosen.th, chosen.tw, chosen.ck) else "")
                print(f"  blocks {ids} {cin}->{ce}->{cout} rate {rate} "
                      f"{H}x{W}: {tile[0]}x{tile[1]} chunk {ck} stages "
                      f"{p.stages} nt {p.nt}: {ms:.4f} ms, estimate "
                      f"{p.est_clk:.0f} clk{mark} [{card}]", flush=True)
        FM.MBCONV_TILES, FM.MBCONV_CHUNKS = tiles, chunks
        FM.mbconv_plan.cache_clear()
    print(card)
    return 0


def train_block_calls(dev, B, H, W, cin, ce, cout, rate, skip, seed):
    """One training block forward and backward at B with seeded weights,
    every phase through its plain version on ``dev``: the recorded
    {phase: [(args, kw, out)]}, one call each."""
    import numpy as np
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
    r = np.random.RandomState(seed)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (r.randn(*s) * sc).astype(np.float32)).to(dev)
    x = t(B, H, W, cin).to(torch.bfloat16).requires_grad_()
    w = [t(cin, ce, sc=0.3), 1 + t(ce, sc=0.1), t(ce, sc=0.1),
         t(9, ce, sc=0.3), 1 + t(ce, sc=0.1), t(ce, sc=0.1),
         t(ce, cout, sc=0.2), 1 + t(cout, sc=0.1), t(cout, sc=0.1)]
    # w2 laid out as the net holds it: the transpose of the project kernel
    w[6] = w[6].t().contiguous().t()
    w = [v.requires_grad_() for v in w]
    with FMT.plain_versions() as calls:
        out, _ = FMT.block_train(x, *w, rate=rate, skip=skip)
        (out.float() * t(B, H, W, cout)).sum().backward()
    return calls


def train_phase_times(card) -> dict:
    """``--train-phases``: each training phase per launch at every block
    shape of the net at B=16, seeded inputs from the plain versions, held to
    its plain version, timed with CUDA events and as device time in a CUDA
    graph beside its bound (F1 and F3 also beside their plain bf16
    composition, ``train_composition``); per step (each shape times its
    block count); and a ``torch.profiler`` split of B2 and B34 by kernel
    name.  Only the
    wrappers' public API is used, so a copy of this file run from the root
    of a parent checkout times that checkout's kernels.  The counts of
    launches move; callers restore them."""
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
    from deeplab_tpu_torch.models import mobilenetv2 as M
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    step = {n: {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0,
                "composition_ms": 0.0} for n in FMT.PHASES}
    failed = []
    for ids, cin, ce, cout, rate, skip, st in fused_shapes(M):
        H = W = SIZE // st
        calls = train_block_calls(dev, TRAIN_B, H, W, cin, ce, cout, rate,
                                  skip, SEED + 600 + ids[0])
        row = []
        for name in FMT.PHASES:
            kernel = getattr(FMT, name)
            args, kw, want = calls[name][0]
            with torch.no_grad():
                got = kernel(*args, **kw)
                torch.cuda.synchronize()
                _, rel, ok = FMT.max_err_vs_plain(got, want)
                if not ok:
                    failed.append(f"{name} at blocks {ids}: (abs, rel) by "
                                  f"output " + str([
                                      FMT.max_err_vs_plain(g, w)[:2]
                                      for g, w in zip(got, want)]))
                del got
                ms = cuda_ms(lambda: kernel(*args, **kw), 10)
                dev_ms = graph_ms(lambda: kernel(*args, **kw), iters=5)
                comp = (cuda_ms(train_composition(name, args), 10)
                        if name in ("f1", "f3") else 0.0)
            bms, _ = train_bound_ms(name, args, want)
            for k, v in (("ms", ms), ("device_ms", dev_ms),
                         ("bound_ms", bms), ("composition_ms", comp)):
                step[name][k] += len(ids) * v
            row.append(f"{name} {ms:.4f} (device {dev_ms:.4f}, bound "
                       f"{bms:.4f}"
                       + (f", composition {comp:.4f}" if comp else "")
                       + f"{'' if ok else ', FAILS its plain version'}"
                       f", rel {rel:.2e})")
        by_kernel = []
        for name in ("b2", "b34"):
            args, kw, _ = calls[name][0]
            with torch.no_grad(), profile(
                    activities=[ProfilerActivity.CUDA]) as pr:
                for _ in range(3):
                    getattr(FMT, name)(*args, **kw)
                torch.cuda.synchronize()
            split = sorted(((e.key.replace("(anonymous namespace)::", "")
                             .split("(")[0][:40],
                             e.self_device_time_total / 3e3)
                            for e in pr.key_averages()
                            if e.self_device_time_total > 0),
                           key=lambda kv: -kv[1])
            by_kernel.append(f"; {name.upper()} by kernel (device ms): "
                             + ", ".join(f"{k} {v:.4f}" for k, v in split))
        print(f"  train phases, blocks {ids} {cin}->{ce}->{cout} rate {rate} "
              f"{TRAIN_B}x{H}x{W}, ms a launch: " + "; ".join(row)
              + "".join(by_kernel) + f" [{card}]", flush=True)
        del calls
    for name in FMT.PHASES:
        s = step[name]
        comp = (f", composition {s['composition_ms']:.4f} ms"
                if name in ("f1", "f3") else "")
        print(f"  train phase {name} per step ({TRAIN_PER_STEP} launches, "
              f"B={TRAIN_B}): {s['ms']:.4f} ms (device {s['device_ms']:.4f}),"
              f" bound {s['bound_ms']:.4f} ms{comp} [{card}]", flush=True)
    if failed:
        raise AssertionError("phases that disagree with their plain "
                             "versions: " + "; ".join(failed))
    return step


def train_plan_sweep(card, phases=("f2", "b34", "f1", "f3")) -> int:
    """``--train-plan-sweep``: every (tile, chunk) that ``train_plan`` may
    choose for F2 and B34, every (warpgroups, ring) for F1 and (Cout
    split, chunk, ring) for F3, forced, held to the plain version and
    timed (device time in a CUDA graph) at each block shape of the net at
    B=16, beside the plan's choice and its cost model's estimate; only the
    named ``phases`` where the command line names some."""
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
    from deeplab_tpu_torch.models import mobilenetv2 as M
    dev = torch.device("cuda")
    tiles, chunks = FMT.TRAIN_TILES, FMT.TRAIN_CHUNKS
    bad = []
    for ids, cin, ce, cout, rate, skip, st in fused_shapes(M):
        H = W = SIZE // st
        calls = train_block_calls(dev, TRAIN_B, H, W, cin, ce, cout, rate,
                                  skip, SEED + 600 + ids[0])
        for name in [n for n in ("f2", "b34") if n in phases]:
            args, kw, want = calls[name][0]
            kernel = getattr(FMT, name)
            chosen = FMT.train_plan(name, TRAIN_B, H, W, cin, ce, cout, rate)
            for tile in tiles:
                for ck in chunks:
                    FMT.TRAIN_TILES, FMT.TRAIN_CHUNKS = (tile,), (ck,)
                    FMT.train_plan.cache_clear()
                    try:
                        p = FMT.train_plan(name, TRAIN_B, H, W, cin, ce, cout,
                                           rate)
                    except ValueError:
                        continue
                    with torch.no_grad():
                        ok = FMT.max_err_vs_plain(kernel(*args, **kw),
                                                  want)[2]
                        ms = graph_ms(lambda: kernel(*args, **kw), iters=5)
                    if not ok:
                        bad.append((name, ids, tile, ck))
                    mark = ("  <- plan" if (p.th, p.tw, p.ck) == (
                        chosen.th, chosen.tw, chosen.ck) else "")
                    print(f"  {name} blocks {ids} {cin}->{ce} rate {rate} "
                          f"{TRAIN_B}x{H}x{W}: {tile[0]}x{tile[1]} chunk {ck}"
                          f" stages {p.stages}: {ms:.4f} ms"
                          f"{'' if ok else ' FAILS its plain version'}, "
                          f"estimate {p.est_clk:.0f} clk{mark} [{card}]",
                          flush=True)
            FMT.TRAIN_TILES, FMT.TRAIN_CHUNKS = tiles, chunks
            FMT.train_plan.cache_clear()
        for name, knobs in (("f1", ("F1_WGS",)),
                            ("f3", ("F3_CASES", "F3_STAGES"))):
            if name not in phases:
                continue
            args, kw, want = calls[name][0]
            kernel = getattr(FMT, name)
            chosen = FMT.train_plan(name, TRAIN_B, H, W, cin, ce, cout, rate)
            saved = {k: getattr(FMT, k) for k in knobs}
            for combo in itertools.product(*saved.values()):
                for k, v in zip(knobs, combo):
                    setattr(FMT, k, (v,))
                FMT.train_plan.cache_clear()
                try:
                    p = FMT.train_plan(name, TRAIN_B, H, W, cin, ce, cout,
                                       rate)
                except ValueError:
                    continue
                with torch.no_grad():
                    ok = FMT.max_err_vs_plain(kernel(*args, **kw), want)[2]
                    ms = graph_ms(lambda: kernel(*args, **kw), iters=5)
                if not ok:
                    bad.append((name, ids, combo))
                mark = ("  <- plan" if p.fields == chosen.fields else "")
                print(f"  {name} blocks {ids} {cin}->{ce}->{cout} "
                      f"{TRAIN_B}x{H}x{W}: {dict(zip(knobs, combo))} splits "
                      f"{p.splits} stages {p.stages} smem {p.smem}: "
                      f"{ms:.4f} ms{'' if ok else ' FAILS its plain version'}"
                      f"{mark} [{card}]", flush=True)
            for k, v in saved.items():
                setattr(FMT, k, v)
            FMT.train_plan.cache_clear()
        del calls
    print(card)
    return 1 if bad else 0


def train_step_times(card, runs: int = 10) -> int:
    """``--train-step``: the bf16 train step of the full-width 512x512 net
    at B=16 with the block kernels, seeded weights and one seeded batch,
    timed with CUDA events (``runs`` steps after two of warm-up), its peak
    device memory, and its device busy share under ``torch.profiler`` over
    three steps.  Only the public API is used, so a copy of this file run
    from the root of a parent checkout times that checkout, for parent and
    change in turns in one call."""
    from deeplab_tpu_torch.kernels import build
    from deeplab_tpu_torch.train import Trainer
    from torch.profiler import ProfilerActivity, profile
    build.build(["fused_mbconv_train", "fused_mbconv", "fused_dw"])
    dev = torch.device("cuda")
    net = seeded_net((SIZE, SIZE), SEED + 5, dev)
    net.fuse_blocks = True
    imgs, masks = scene_batch(TRAIN_B, SEED + 500, dev)
    X, Y = imgs, masks.reshape(TRAIN_B, -1, 1).to(torch.int32)
    SW = torch.ones((TRAIN_B, SIZE * SIZE), device=dev)
    t = Trainer(net, compute_dtype=torch.bfloat16, verbose=0)
    t.setup(net)
    t.train_step(X, Y, SW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: t.train_step(X, Y, SW), runs, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            t.train_step(X, Y, SW)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 3
    busy = sum(e.self_device_time_total for e in pr.key_averages()
               if e.self_device_time_total > 0
               and str(e.device_type).endswith("CUDA")) / 3e3
    print(f"  train step bf16, block kernels B={TRAIN_B}: {ms:.3f} ms/step, "
          f"{1e3 * TRAIN_B / ms:.1f} img/s, peak device memory {peak:.2f} "
          f"GiB; under torch.profiler device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall (idle share {1 - busy / wall:.3f}) [{card}]",
          flush=True)
    return 0


def blur_times(CK, a, gn, kw, card, rows=True) -> dict:
    """The y and x passes launched directly on one blur input (the x pass on
    the y pass's output) and, where ``rows``, the spatial blur through
    gaussian_blur_planes' dispatch, each per launch with CUDA events beside
    its bound, its plain version and one depthwise ``F.conv2d`` of the same
    taps over the image the cells tile (bf16, groups = L)."""
    import torch.nn.functional as F
    dev = a.device
    B, L, K = kw["B"], a.shape[1], len(kw["taps"])
    r = K // 2
    img = torch.rand((B, L, kw["ny"] * kw["cs_y"], kw["nx"] * kw["cs_x"]),
                     device=dev).to(torch.bfloat16)
    tb = torch.tensor(kw["taps"], device=dev).to(torch.bfloat16)
    ty, tx = tb.view(1, 1, K, 1), tb.view(1, 1, 1, K)
    ker = {"gaussian_blur_y_planes": (ty.expand(L, 1, K, 1), (r, 0)),
           "gaussian_blur_x_planes": (tx.expand(L, 1, 1, K), (0, r)),
           "rows": ((ty * tx).expand(L, 1, K, K), (r, r))}
    out = {}
    with torch.inference_mode():
        y = CK.gaussian_blur_y_planes(a, gn, **kw)
        x = CK.gaussian_blur_x_planes(y, **kw)
        cases = {"gaussian_blur_y_planes": (
            lambda: CK.gaussian_blur_y_planes(a, gn, **kw),
            lambda: CK.gaussian_blur_y_planes_reference(a, gn, **kw),
            (a, gn), y),
                 "gaussian_blur_x_planes": (
            lambda: CK.gaussian_blur_x_planes(y, **kw),
            lambda: CK.gaussian_blur_x_planes_reference(y, **kw),
            (y,), x)}
        if rows:
            cases["rows"] = (
                lambda: CK.gaussian_blur_planes(a, gn, **kw),
                lambda: CK.gaussian_blur_planes_reference(a, gn, **kw),
                (a, gn), CK.gaussian_blur_planes(a, gn, **kw))
        for name, (kern, plain, args, res) in cases.items():
            ms = cuda_ms(kern, 20)
            dms = graph_ms(kern, 20)
            pms = cuda_ms(plain, 3, warmup=1)
            wgt, pad = ker[name]
            wgt = wgt.contiguous()
            lms = cuda_ms(lambda: F.conv2d(img, wgt, padding=pad, groups=L),
                          10)
            bname = "gaussian_blur_planes" if name == "rows" else name
            bms, bb = crf_bound_ms(CK, bname, args, kw, res)
            out[name] = dict(ms=ms, device_ms=dms, plain_ms=pms,
                             bound_ms=bms, bound_by=bb, library_ms=lms)
            print(f"  {name} per launch, inputs "
                  f"{[tuple(v.shape) for v in args]} (cells {kw['cs_y']}x"
                  f"{kw['cs_x']}, r = {r}): kernel {ms:.4f} ms (device "
                  f"{dms:.4f}), plain "
                  f"{pms:.4f} ms, bound {bms:.4f} ms ({bb}), {bms / ms:.3f} "
                  f"of bound; F.conv2d groups={L} "
                  f"{K if name != 'rows' else f'{K}x{K}'}-tap bf16 {lms:.4f} "
                  f"ms [{card}]")
    return out


def wide_blur_input(dev):
    """A seeded (8, 512, 512) blur input in 64x128 cells at 21 labels and
    the taps of sxy_gaussian 8 (r = 20), gn (Z, 1, P): (a, gn, kw)."""
    from deeplab_tpu_torch.crf import dense_crf as DC
    gen = torch.Generator(dev).manual_seed(SEED + 90)
    kw = dict(taps=tuple(float(t) for t in DC._gauss_taps(8.0)), B=SERVE_B,
              ny=8, nx=4, cs_y=64, cs_x=128)
    a = torch.rand((SERVE_B * 32, CLASSES, 64 * 128), generator=gen,
                   device=dev).to(torch.bfloat16)
    gn = 0.5 + torch.rand((32, 1, 64 * 128), generator=gen, device=dev)
    return a, gn, kw


def crf_fallback_times(card) -> None:
    """``--crf-fallbacks``: slice_planes per launch and per 512x512 image of
    the XLA engine at FAITHFUL_CONFIG, with a digest of its outputs; the
    passes and the spatial blur's dispatch on a (8, 375, 500) batch's blur
    input (r = 8) and the passes at r = 20 on (8, 512, 512); the CRF per
    (8, 375, 500) batch.  Public API only."""
    import dataclasses as dc
    import hashlib
    import numpy as np
    from deeplab_tpu_torch import crf as CRF
    from deeplab_tpu_torch.crf import dense_crf as DC
    from deeplab_tpu_torch.kernels import crf_fused as CK
    dev = torch.device("cuda")
    im, mask = make_scene(SIZE, SIZE, CLASSES, SEED + 30)
    im = torch.from_numpy(im).to(dev)
    U = DC.unary_from_labels(torch.from_numpy(mask).reshape(-1).to(dev),
                             CLASSES, 0.7, zero_unsure=False)
    cfg = dc.replace(CRF.FAITHFUL_CONFIG, backend="xla")
    with torch.inference_mode(), CK.plain_versions(CK.XLA_KERNELS) as calls:
        CRF.mean_field(im, U, cfg, CLASSES)
    per_image = per_image_device = 0.0
    digest = hashlib.sha256()
    for idx, n in ((0, 1), (1, 5)):
        args, kw, want = calls["slice_planes"][idx]
        with torch.inference_mode():
            got = CK.slice_planes(*args, **kw)
            ms = cuda_ms(lambda: CK.slice_planes(*args, **kw), 50)
            dms = graph_ms(lambda: CK.slice_planes(*args, **kw), 20)
        err = (got - want).abs().max().item()
        digest.update(got.cpu().numpy().tobytes())
        bms, bb = crf_bound_ms(CK, "slice_planes", args, kw, got)
        per_image += n * ms
        per_image_device += n * dms
        print(f"  slice_planes L={kw['L']} (x{n} per image) inputs "
              f"{[tuple(t.shape) for t in tensors(args)]}: {ms:.4f} ms a "
              f"launch (device {dms:.4f}), bound {bms:.4f} ms ({bb}); "
              f"max_abs vs plain {err:.3e} [{card}]")
    print(f"  slice_planes per 512x512 XLA-engine image at FAITHFUL_CONFIG: "
          f"{per_image:.4f} ms (device {per_image_device:.4f}); outputs' "
          f"sha256 {digest.hexdigest()[:16]} [{card}]")
    pairs = [make_scene(375, 500, CLASSES, SEED + 800 + k)
             for k in range(SERVE_B)]
    imgs = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    masks = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    with torch.inference_mode(), CK.plain_versions() as calls:
        CRF.mean_field_batched(imgs, masks, CRF.PRODUCTION_CONFIG, CLASSES)
    (a, gn), kw, _ = calls["gaussian_blur_planes"][0]
    blur_times(CK, a, gn, kw, card)
    blur_times(CK, *wide_blur_input(dev), card, rows=False)
    with torch.inference_mode():
        ms = cuda_ms(lambda: CRF.mean_field_batched(
            imgs, masks, CRF.PRODUCTION_CONFIG, CLASSES), 10, warmup=2)
    print(f"  mean_field_batched PRODUCTION_CONFIG ({SERVE_B}, 375, 500): "
          f"{ms:.3f} ms/batch [{card}]")


def crf_scene_batches(dev):
    """(name, images, masks) at PRODUCTION_CONFIG's serving batch: the
    structured 512x512 scenes, one flat color (every pixel of a cell on one
    bin: the splat's most contention), uniform noise (its keys all but
    distinct), and the structured scenes cut to the VOC size 375x500."""
    imgs, masks = scene_batch(SERVE_B, SEED + 200, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    noise = torch.rand(imgs.shape, generator=gen, device=dev) * 255
    return [("structured", imgs, masks),
            ("flat", torch.full_like(imgs, 128.0), masks),
            ("noise", noise, masks),
            ("structured 375x500", imgs[:, :375, :500].contiguous(),
             masks[:, :375, :500].contiguous())]


def crf_scene_times(card) -> dict:
    """The splat (the norm pass and an iteration) and the step (an
    iteration's, with its subsampled copy) per launch on each scene of
    ``crf_scene_batches``, beside their bounds, the step also in its
    two-kernel form where the port has one, and the CRF alone per batch.
    Only the wrappers' public API is used, so a copy of this file run from
    the root of a parent checkout times that checkout's kernels
    (``--crf-scenes``).  The counts of launches move; callers restore
    them."""
    from deeplab_tpu_torch import crf as CRF
    from deeplab_tpu_torch.kernels import crf_fused as CK
    cfg = CRF.PRODUCTION_CONFIG
    res = {}
    for scene, imgs, masks in crf_scene_batches(torch.device("cuda")):
        with torch.inference_mode(), CK.plain_versions() as calls:
            CRF.mean_field_batched(imgs, masks, cfg, CLASSES)
        row = {}
        launches = (("splat_norm", "splat_planes", 0),
                    ("splat_iter", "splat_planes", 1),
                    ("step", "mf_step_planes", 0))
        with torch.inference_mode():
            for key, name, idx in launches:
                args, kw, out = calls[name][idx]
                kernel = getattr(CK, name)
                ms = cuda_ms(lambda: kernel(*args, **kw), 20)
                dev_ms = graph_ms(lambda: kernel(*args, **kw))
                bms, _ = crf_bound_ms(CK, name, args, kw, out)
                row[key] = {"ms": ms, "device_ms": dev_ms, "bound_ms": bms}
                if name == "mf_step_planes" and hasattr(CK, "step_plan"):
                    plan = CK.step_plan(args[0].shape[0], args[0].shape[2],
                                        kw["nc"], kw["L"])
                    two = CK.two_kernel_step_plan(kw["nc"], kw["L"])
                    row[key]["fused"] = plan.fused
                    row[key]["two_kernel_ms"] = graph_ms(
                        lambda: CK.mf_step_with_plan(two, *args, **kw))
            row["crf_ms"] = cuda_ms(lambda: CRF.mean_field_batched(
                imgs, masks, cfg, CLASSES), 10, warmup=2)
        shapes = [tuple(t.shape) for t in calls["splat_planes"][1][0][:2]]
        what = {"splat_norm": "splat norm pass", "splat_iter":
                "splat iteration", "step": "step"}
        print(f"  CRF scene {scene} {tuple(imgs.shape)} (iteration splat "
              f"inputs {shapes}): "
              + ", ".join(f"{what[k]} {row[k]['ms']:.4f} ms (device "
                          f"{row[k]['device_ms']:.4f}, bound "
                          f"{row[k]['bound_ms']:.4f})" for k in what)
              + (f", the step's two-kernel form device "
                 f"{row['step']['two_kernel_ms']:.4f} ms (plan: "
                 f"{'fused' if row['step']['fused'] else 'two kernels'})"
                 if "two_kernel_ms" in row["step"] else "")
              + f"; CRF alone {row['crf_ms']:.3f} ms/batch [{card}]",
              flush=True)
        res[scene] = row
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if "--plan-sweep" in sys.argv[1:]:
        return plan_sweep()
    if "--dw" in sys.argv[1:]:
        return dw_times(card_line())
    if "--crf-fallbacks" in sys.argv[1:]:
        from deeplab_tpu_torch.kernels import build
        card = card_line()
        build.build(["crf_fused"])
        crf_fallback_times(card)
        print(card)
        return 0
    if "--crf-scenes" in sys.argv[1:]:
        from deeplab_tpu_torch.kernels import build
        card = card_line()
        build.build(["crf_fused"])
        crf_scene_times(card)
        print(card)
        return 0
    if "--sepconv-shapes" in sys.argv[1:]:
        from deeplab_tpu_torch.kernels import build
        card = card_line()
        for kern, info in ptxas_table(
                build.build(["fused_sepconv"])["fused_sepconv"]):
            print(f"  [fused_sepconv] {kern}: {info}")
        sepconv_shape_times(card)
        print(card)
        return 0
    if "--sepconv-plan-sweep" in sys.argv[1:]:
        from deeplab_tpu_torch.kernels import build
        build.build(["fused_sepconv"])
        return sepconv_plan_sweep(card_line())
    if "--train-plan-sweep" in sys.argv[1:]:
        from deeplab_tpu_torch.kernels import build
        build.build(["fused_mbconv_train"])
        named = [a for a in sys.argv[1:] if a in ("f1", "f2", "f3", "b34")]
        return train_plan_sweep(card_line(), *([named] if named else []))
    if "--train-step" in sys.argv[1:]:
        return train_step_times(card_line())
    if "--train-phases" in sys.argv[1:]:
        from deeplab_tpu_torch.kernels import build
        card = card_line()
        for kern, info in ptxas_table(
                build.build(["fused_mbconv_train"])["fused_mbconv_train"]):
            print(f"  [fused_mbconv_train] {kern}: {info}")
        train_phase_times(card)
        print(card)
        return 0
    import numpy as np
    from deeplab_tpu_torch import Predictor
    from deeplab_tpu_torch import crf as CRF
    from deeplab_tpu_torch.crf import dense_crf as DC
    from deeplab_tpu_torch.kernels import build
    from deeplab_tpu_torch.kernels import crf_fused as CK
    from deeplab_tpu_torch.kernels import fused_dw as FDW
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
    from deeplab_tpu_torch.models import mobilenetv2 as M
    from deeplab_tpu_torch.ops.bn import bn_scale_shift
    from deeplab_tpu_torch.data.generator import ArrayBatcher
    from deeplab_tpu_torch.train import Trainer
    from deeplab_tpu_torch import core
    from deeplab_tpu_torch import viz

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    run = Run()
    kernel_report = {}
    CRF_KERNELS = CK.KERNELS + CK.BLUR_PASSES + ("slice_planes",)
    crf_report = {n: {"max_abs_err": 0.0} for n in CRF_KERNELS}
    crf_b8 = {}
    dw_report = {}
    serving = {}
    notebook = {}
    geo = {}

    train_report = {n: {"max_abs_err": 0.0} for n in FMT.PHASES}
    train = {}

    sepconv_report = {}
    xc = {}

    def zero_counts():
        FM.fused_mbconv.launches = 0
        FM.fused_sepconv.launches = 0
        FDW.fused_dw_bn_relu6.launches = 0
        for n in CRF_KERNELS:
            getattr(CK, n).launches = 0
        for n in FMT.PHASES:
            getattr(FMT, n).launches = 0

    def counts():
        out = {"fused_mbconv": FM.fused_mbconv.launches,
               "fused_sepconv": FM.fused_sepconv.launches,
               "fused_dw_bn_relu6": FDW.fused_dw_bn_relu6.launches}
        out.update({n: getattr(CK, n).launches for n in CRF_KERNELS})
        out.update({"train_" + n: getattr(FMT, n).launches
                    for n in FMT.PHASES})
        return out

    def set_counts(saved):
        FM.fused_mbconv.launches = saved["fused_mbconv"]
        FM.fused_sepconv.launches = saved["fused_sepconv"]
        FDW.fused_dw_bn_relu6.launches = saved["fused_dw_bn_relu6"]
        for n in CRF_KERNELS:
            getattr(CK, n).launches = saved[n]
        for n in FMT.PHASES:
            getattr(FMT, n).launches = saved["train_" + n]

    # 1. build --------------------------------------------------------------
    def do_build():
        t0 = time.perf_counter()
        logs = build.build(["fused_mbconv", "crf_fused",
                            "fused_mbconv_train", "fused_sepconv",
                            "fused_dw"])
        print(f"build seconds: {time.perf_counter() - t0:.2f}")
        for name, log in logs.items():
            for kern, info in ptxas_table(log):
                print(f"  [{name}] {kern}: {info}")
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

    def check_fused_dw():
        gen = torch.Generator(dev).manual_seed(SEED + 20)
        worst = 0.0
        for pol_name in ("mixed", "bfloat16"):
            dt = core.resolve_compute_dtype(pol_name).dtype
            for shape in DW_SHAPES:
                B, H, W, C, rate = shape
                x, k, scale, shift = dw_inputs(shape, dt, gen, dev)
                got = FDW.fused_dw_bn_relu6(x, k, scale, shift, rate=rate)
                ref = FDW.fused_dw_bn_relu6_reference(x, k, scale, shift,
                                                      rate=rate)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale_ = ref.float().abs().max().item()
                rel = err / max(scale_, 1e-30)
                tol = DW_REL_TOL[pol_name]
                same = torch.equal(got, ref)
                ok = (math.isfinite(err) and got.dtype == dt and rel <= tol
                      and same)
                print(f"  {pol_name:8s} ({B}, {H}, {W}, {C}) rate {rate}: "
                      f"max_abs {err:.3e} max|ref| {scale_:.3e} rel "
                      f"{rel:.3e} (tol {tol:.4g}), bit for bit {same} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"fused_dw_bn_relu6 disagrees at "
                                         f"{(B, H, W, C, rate)}")
                worst = max(worst, err)
        dw_report["max_abs_err"] = worst
    run.phase("fused_dw_bn_relu6 vs plain version", check_fused_dw)

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
                    if (name == "mf_step_planes" and CK.step_plan(
                            args[0].shape[0], args[0].shape[2], kw["nc"],
                            kw["L"]).fused):
                        # the two-kernel form sums in the fused one's order
                        with torch.inference_mode():
                            two = CK.mf_step_with_plan(
                                CK.two_kernel_step_plan(kw["nc"], kw["L"]),
                                *args, **kw)
                        if not all(torch.equal(a, b)
                                   for a, b in zip(got, two)):
                            raise AssertionError(
                                f"the step's two forms differ at {cfg_name} "
                                f"B={B}")
                    if name == "gaussian_blur_planes":
                        # tap order and exact products, as the y and x
                        # plain versions: their chain, bit for bit
                        with torch.inference_mode():
                            chain = CK.gaussian_blur_x_planes_reference(
                                CK.gaussian_blur_y_planes_reference(
                                    *args, **kw), **kw)
                        if not torch.equal(got, chain):
                            raise AssertionError(
                                f"row blur differs from the chained plain "
                                f"passes at {cfg_name} B={B}")
                rep = crf_report[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], max(errs))
                print(f"  {cfg_name:20s} B={B} {name:20s} {len(errs)} calls: "
                      f"max_abs {max(errs):.3e} (rel tol: f32 "
                      f"{CK.PLAIN_F32_REL}, bf16 {CK.PLAIN_BF16_REL:.4g}, "
                      f"step Q {CK.PLAIN_STEP_REL:.4g}) ok"
                      + ("; equal bit for bit to the chained y and x plain "
                         "passes" if name == "gaussian_blur_planes" else "")
                      + ("; the two-kernel form equal bit for bit"
                         if name == "mf_step_planes" else ""))
            if cfg_name == "PRODUCTION_CONFIG" and B == SERVE_B:
                crf_b8.update(calls)
    run.phase("CRF kernels vs plain versions", check_crf_kernels)

    def check_xla_kernels():
        """slice_planes and the f32 splat at L = 21 on every call of the XLA
        engine's 512x512 mean_field (the first call of each the norm pass,
        L = 1)."""
        im, mask = make_scene(SIZE, SIZE, CLASSES, SEED + 30)
        im = torch.from_numpy(im).to(dev)
        U = DC.unary_from_labels(torch.from_numpy(mask).reshape(-1).to(dev),
                                 CLASSES, 0.7, zero_unsure=False)
        for cfg_name in ("FAITHFUL_CONFIG", "PRODUCTION_CONFIG"):
            cfg = dataclasses.replace(getattr(CRF, cfg_name), backend="xla")
            with torch.inference_mode(), \
                    CK.plain_versions(CK.XLA_KERNELS) as calls:
                CRF.mean_field(im, U, cfg, CLASSES)
            for name in CK.XLA_KERNELS:
                kernel = getattr(CK, name)
                assert len(calls[name]) == XLA_PER_IMAGE[name], name
                errs = []
                for args, kw, want in calls[name]:
                    with torch.inference_mode():
                        got = kernel(*args, **kw)
                    torch.cuda.synchronize()
                    err, ok = CK.max_err_vs_plain(name, got, want)
                    errs.append(err)
                    if not ok:
                        raise AssertionError(f"{name} disagrees at {cfg_name}"
                                             f" L={kw['L']}: {err}")
                rep = crf_report[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], max(errs))
                geo = [tuple(t.shape) for t in tensors(calls[name][1][0])]
                print(f"  XLA engine {cfg_name:17s} {name:13s} "
                      f"{len(errs)} calls (L 1, then {CLASSES}; inputs of "
                      f"an iteration {geo}): max_abs {max(errs):.3e} ok")
            if cfg_name == "FAITHFUL_CONFIG":
                notebook["xla_calls"] = calls
    run.phase("XLA-engine kernels (slice_planes, f32 splat) vs plain "
              "versions", check_xla_kernels)

    # 3. the main path ---------------------------------------------------
    @contextlib.contextmanager
    def model_plain_versions():
        """The MobileNetV2 forward with each kernel wrapper replaced by its
        plain version (launch counts untouched)."""
        kernels = FM.fused_mbconv, FDW.fused_dw_bn_relu6
        FM.fused_mbconv = FM.fused_mbconv_reference
        FDW.fused_dw_bn_relu6 = FDW.fused_dw_bn_relu6_reference
        try:
            yield
        finally:
            FM.fused_mbconv, FDW.fused_dw_bn_relu6 = kernels

    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    def serve():
        gen = torch.Generator().manual_seed(SEED + 3)
        reqs = [(torch.rand((SERVE_B, SIZE, SIZE, 3), generator=gen) * 255)
                .numpy() for _ in range(N_REQUESTS)]
        pred = Predictor(net, compute_dtype="mixed")
        zero_counts()
        masks = [pred(r) for r in reqs]
        got = counts()
        want = {k: 0 for k in got}
        want["fused_mbconv"] = FUSED_PER_FORWARD * N_REQUESTS
        want["fused_dw_bn_relu6"] = N_REQUESTS
        print(f"  served {N_REQUESTS} requests of B={SERVE_B}: launches "
              f"{got} (want {want})")
        assert got == want, (got, want)
        for m in masks:
            assert m.shape == (SERVE_B, SIZE, SIZE) and m.dtype == np.int32
            assert m.min() >= 0 and m.max() < CLASSES
        print(f"  classes present in the masks: "
              f"{len(np.unique(np.concatenate(masks)))}")

        img = torch.from_numpy(reqs[0]).to(dev)
        fused = net.logits(img, "mixed").float()
        assert torch.isfinite(fused).all()
        # the same forward with each kernel call replaced by its plain version
        with model_plain_versions():
            in_situ = net.logits(img, "mixed").float()
        # the plain layer composition, under "mixed" and under float32
        net.fuse_blocks = False
        try:
            plain = net.logits(img, "mixed").float()
            f32 = net.logits(img, "float32").float()
        finally:
            net.fuse_blocks = True
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
        want["fused_dw_bn_relu6"] = N_REQUESTS
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

    # 8. the evaluation slice --------------------------------------------
    engines = (("plane", CRF.CrfConfig(), CK.KERNELS, CRF_PER_REQUEST),
               ("xla", CRF.CrfConfig(backend="xla"), CK.XLA_KERNELS,
                XLA_PER_IMAGE))

    def notebook_crf():
        cases = []
        for L in DO_CRF_LABELS:
            im, mask = make_scene(SIZE, SIZE, L, SEED + 40 + L)
            cases += [(im, sparse_mask(mask, L, SEED + L), L, zu)
                      for zu in (False, True)]
        outs = {}
        zero_counts()
        for eng, cfg, _, per_image in engines:
            for i, (im, mask, L, zu) in enumerate(cases):
                before = counts()
                out = CRF.do_crf(im, mask, zero_unsure=zu, cfg=cfg,
                                 device=dev)
                moved = {k: v - before[k] for k, v in counts().items()}
                want = {k: 0 for k in moved}
                want.update(per_image)
                assert moved == want, (eng, L, zu, moved, want)
                assert out.shape == mask.shape and out.dtype == mask.dtype
                assert set(np.unique(out)) <= set(np.unique(mask))
                outs[eng, i] = out
        got = counts()
        notebook["launches"] = got
        print(f"  do_crf on {len(cases)} 512x512 images per engine (label "
              f"ids {DO_CRF_LABELS}, zero_unsure both ways): launches {got}")
        # the same runs with each plain version in its kernel's place
        saved = counts()
        for eng, cfg, names, _ in engines:
            for i, (im, mask, L, zu) in enumerate(cases):
                with CK.plain_versions(names) as calls:
                    ref = CRF.do_crf(im, mask, zero_unsure=zu, cfg=cfg,
                                     device=dev)
                a = float((outs[eng, i] == ref).mean())
                moved = float((outs[eng, i] != mask).mean())
                print(f"  {eng:5s} engine L={L:2d} zero_unsure={zu!s:5s}: "
                      f"masks with kernels vs plain versions {a:.6f} "
                      f"(floor {CRF_PATH_FLOOR}); the CRF changed "
                      f"{moved:.4f} of the pixels")
                assert a >= CRF_PATH_FLOOR, (eng, L, zu, a)
                if eng == "plane" and L == CLASSES and not zu:
                    # every call of this run against its plain version, the
                    # explicit-unary step's in particular
                    for name in CK.KERNELS:
                        errs = []
                        for args, kw, want in calls[name]:
                            with torch.inference_mode():
                                got = getattr(CK, name)(*args, **kw)
                            torch.cuda.synchronize()
                            err, ok = CK.max_err_vs_plain(name, got, want)
                            errs.append(err)
                            assert ok, (name, err)
                        rep = crf_report[name]
                        rep["max_abs_err"] = max(rep["max_abs_err"],
                                                 max(errs))
                        print(f"    {name:20s} {len(errs)} calls: max_abs "
                              f"{max(errs):.3e} ok")
                    # the step took the unary stream on every call
                    assert len(calls["mf_step_planes"]) == 5
                    assert all(c[0][4] is not None
                               for c in calls["mf_step_planes"])
                    notebook["unary_calls"] = calls["mf_step_planes"]
        set_counts(saved)

        # the oracle goldens through do_crf, both engines
        import os
        gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "goldens", "crf")
        for name, H, W, L, seed in GOLDEN_SCENES:
            golden = np.load(os.path.join(gdir, name + ".npz"))["golden"]
            im, mask = make_scene(H, W, L, seed)
            line = []
            for eng, cfg, _, _ in engines:
                for cname, c, floor in (
                        ("CrfConfig()", cfg, GOLDEN_DEFAULT_FLOOR),
                        ("FAST_FAITHFUL", dataclasses.replace(
                            CRF.FAST_FAITHFUL_CONFIG, backend=cfg.backend),
                         GOLDEN_FLOOR)):
                    out = CRF.do_crf(im, mask, zero_unsure=False, cfg=c,
                                     device=dev)
                    a = float((out == golden).mean())
                    line.append(f"{eng} {cname} {a:.5f}")
                    assert a >= floor, (name, eng, cname, a)
            print(f"  golden {name} (do_crf): {', '.join(line)} (floors "
                  f"{GOLDEN_DEFAULT_FLOOR} / {GOLDEN_FLOOR})")
        set_counts(saved)
    run.phase("notebook CRF: do_crf on both engines", notebook_crf)

    def evaluation():
        cfg = CRF.PRODUCTION_CONFIG

        class Batches:
            """4 batches of 8 seeded 512x512 scenes with their label maps,
            the top 8 rows void, as ``(X, Y, None)``."""
            def __init__(self):
                self.items = []
                for i in range(EVAL_BATCHES):
                    imgs, masks = scene_batch(SERVE_B, SEED + 700 + 10 * i,
                                              "cpu")
                    Y = masks.numpy().astype(np.int32)
                    Y[:, :8] = CLASSES
                    self.items.append((imgs.numpy(),
                                       Y.reshape(SERVE_B, -1, 1), None))

            def __len__(self):
                return len(self.items)

            def __getitem__(self, i):
                return self.items[i]
        batches = Batches()
        pred = Predictor(net, crf=cfg, compute_dtype="mixed")

        def recorded(sink):
            def predict(X):
                sink.append(pred(X))
                return sink[-1]
            return predict
        masks = []
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conf, iou, mean = viz.calculate_iou(net, batches, CLASSES,
                                            predict_fn=recorded(masks))
        wall = time.perf_counter() - t0
        got = counts()
        notebook["eval_launches"] = got
        want = {k: 0 for k in got}
        want["fused_mbconv"] = FUSED_PER_FORWARD * EVAL_BATCHES
        want["fused_dw_bn_relu6"] = EVAL_BATCHES
        want.update({n: k * EVAL_BATCHES for n, k in CRF_PER_REQUEST.items()})
        print(f"  calculate_iou over {EVAL_BATCHES} batches of B={SERVE_B} "
              f"through Predictor(crf=PRODUCTION_CONFIG, mixed): launches "
              f"{got} (want {want})")
        assert got == want, (got, want)
        valid = sum(int((b[1] < CLASSES).sum()) for b in batches.items)
        assert conf.shape == (CLASSES, CLASSES) and conf.sum() == valid
        assert np.isfinite(iou).all() and 0 <= mean <= 1
        ms = 1e3 * wall / (EVAL_BATCHES * SERVE_B)
        notebook["eval_ms"] = ms
        print(f"  confusion matrix counts all {valid} non-void pixels; "
              f"published mean IoU {mean:.5f}; the loop took {ms:.3f} ms per "
              f"512x512 image (host clock, first pass) [{card}]")
        plain = []
        saved = counts()
        with model_plain_versions(), CK.plain_versions():
            pconf, _, pmean = viz.calculate_iou(net, batches, CLASSES,
                                                predict_fn=recorded(plain))
        set_counts(saved)
        agree = float(np.mean([(a == b).mean() for a, b in zip(masks,
                                                                plain)]))
        print(f"  the same loop with every plain version in its kernel's "
              f"place: masks agree {agree:.6f} (floor {CRF_PATH_FLOOR}), "
              f"published mean {pmean:.5f} (kernels {mean:.5f}, tol "
              f"{EVAL_MEAN_TOL})")
        assert agree >= CRF_PATH_FLOOR
        assert abs(mean - pmean) <= EVAL_MEAN_TOL
        with torch.inference_mode():
            ms2 = cuda_ms(lambda: viz.calculate_iou(net, batches, CLASSES,
                                                    predict_fn=pred), 2,
                          warmup=1)
        print(f"  the loop again, warm: {ms2 / (EVAL_BATCHES * SERVE_B):.3f} "
              f"ms per image (CUDA events around the whole loop) [{card}]")
    run.phase("evaluation: viz.calculate_iou through Predictor(crf="
              "PRODUCTION_CONFIG)", evaluation)

    def slice_times():
        """The evaluation slice's kernels beside their bounds: fused_dw at
        block 0 of a B=8 forward (its folded weights), with block 0 through
        the layer composition beside it; slice_planes per 512x512 image of
        the XLA engine; do_crf per image on each engine."""
        saved = counts()
        pol = core.resolve_compute_dtype("mixed")
        gen = torch.Generator(dev).manual_seed(SEED + 50)
        p = M._prefix(0)
        C = net.Conv.kernel.shape[0]
        x = torch.rand((SERVE_B, C, SIZE // 2, SIZE // 2), generator=gen,
                       device=dev) * 6
        x = x.contiguous(memory_format=torch.channels_last)
        scale, shift = (t.contiguous() for t in bn_scale_shift(
            getattr(net, p + "depthwise_BN")))
        taps = getattr(net, p + "depthwise").depthwise_kernel.float() \
            .permute(2, 3, 0, 1).contiguous()
        xh = x.permute(0, 2, 3, 1)
        with torch.inference_mode():
            ms = cuda_ms(lambda: FDW.fused_dw_bn_relu6(xh, taps, scale,
                                                       shift), 50)
            dms = graph_ms(lambda: FDW.fused_dw_bn_relu6(xh, taps, scale,
                                                         shift))
            plain = cuda_ms(lambda: FDW.fused_dw_bn_relu6_reference(
                xh, taps, scale, shift), 20)
            with core.precision_flags(pol):
                comp = cuda_ms(lambda: M.relu6(
                    getattr(net, p + "depthwise_BN")(
                        getattr(net, p + "depthwise")(x, pol))), 50)
        bms, bb = dw_bound_ms(xh)
        dw_report.update(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
                         bound_by=bb, composition_ms=comp)
        print(f"  fused_dw_bn_relu6 block 0, ({SERVE_B}, {SIZE // 2}, "
              f"{SIZE // 2}, {C}) f32 io: kernel {ms:.4f} ms (device "
              f"{dms:.4f}), plain "
              f"{plain:.4f} ms, bound {bms:.4f} ms ({bb}), {bms / ms:.3f} "
              f"of bound; the layer composition (grouped conv, BN affine, "
              f"clamp, under mixed) {comp:.4f} ms [{card}]")

        calls = notebook.pop("xla_calls")
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        by = {"bytes": 0.0, "operations": 0.0}
        for idx, n in ((0, 1), (1, 5)):
            args, kw, out = calls["slice_planes"][idx]
            with torch.inference_mode():
                ms = cuda_ms(lambda: CK.slice_planes(*args, **kw), 20)
                dms = graph_ms(lambda: CK.slice_planes(*args, **kw), 20)
                plain = cuda_ms(lambda: CK.slice_planes_reference(
                    *args, **kw), 3, warmup=1)
            bms, bb = crf_bound_ms(CK, "slice_planes", args, kw, out)
            tot["ms"] += n * ms
            tot["device_ms"] += n * dms
            tot["plain_ms"] += n * plain
            tot["bound_ms"] += n * bms
            by[bb] += n * bms
            print(f"  slice_planes L={kw['L']} (x{n} per image) inputs "
                  f"{[tuple(t.shape) for t in tensors(args)]}: kernel "
                  f"{ms:.4f} ms (device {dms:.4f}), plain {plain:.4f} ms, "
                  f"bound {bms:.4f} ms ({bb}), {bms / ms:.3f} of bound "
                  f"[{card}]")
        crf_report["slice_planes"].update(tot)
        crf_report["slice_planes"]["bound_by"] = max(by, key=by.get)
        crf_report["slice_planes"]["library_ms"] = None
        # the explicit-unary step per plane-engine do_crf image (its 5 calls)
        unary = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for args, kw, out in notebook.pop("unary_calls"):
            with torch.inference_mode():
                unary["ms"] += cuda_ms(lambda: CK.mf_step_planes(*args, **kw),
                                       20)
                unary["plain_ms"] += cuda_ms(
                    lambda: CK.mf_step_planes_reference(*args, **kw), 2,
                    warmup=1)
            unary["bound_ms"] += crf_bound_ms(CK, "mf_step_planes", args, kw,
                                              out)[0]
        notebook["unary_times"] = unary
        print(f"  mf_step_planes, explicit unary, per 512x512 plane-engine "
              f"do_crf image (5 launches, {CLASSES} labels): kernel "
              f"{unary['ms']:.4f} ms, plain {unary['plain_ms']:.4f} ms, "
              f"bound {unary['bound_ms']:.4f} ms [{card}]")
        print(f"  slice_planes per 512x512 image (XLA engine, "
              f"FAITHFUL_CONFIG): kernel {tot['ms']:.4f} ms (device "
              f"{tot['device_ms']:.4f}), plain "
              f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
              f"[{card}]")

        im, mask = make_scene(SIZE, SIZE, CLASSES, SEED + 60)
        mask = sparse_mask(mask, CLASSES, SEED + 61)
        for eng, cfg, _, _ in engines:
            for _ in range(2):
                CRF.do_crf(im, mask, zero_unsure=False, cfg=cfg, device=dev)
            host = []
            for _ in range(5):
                t0 = time.perf_counter()
                CRF.do_crf(im, mask, zero_unsure=False, cfg=cfg, device=dev)
                host.append(1e3 * (time.perf_counter() - t0))
            colors, labels = np.unique(mask, return_inverse=True)
            U = DC.unary_from_labels(torch.from_numpy(labels.reshape(-1))
                                     .to(dev), len(colors), 0.7, False)
            imd = torch.from_numpy(im).to(dev)
            dms = cuda_ms(lambda: CRF.mean_field(imd, U, cfg, len(colors)),
                          5, warmup=1)
            notebook[eng + "_ms"] = (dms, sorted(host)[2])
            print(f"  do_crf {eng} engine, 512x512, 21 labels: mean_field "
                  f"{dms:.3f} ms (CUDA events); do_crf {sorted(host)[2]:.3f} "
                  f"ms median, {min(host):.3f} min (host clock incl. "
                  f"np.unique and copies) [{card}]")
        set_counts(saved)

    run.phase("evaluation-slice times", slice_times)

    # 9. the rest of the CRF ---------------------------------------------
    def blur_pass_check(a, gn, kw, where):
        """The y and x kernels against their plain versions on one blur
        input, bit for bit (both sum the taps in tap order with exact
        products); the x kernel takes the y pass's plain output, so both
        sides of each comparison take the same input."""
        y_ref = CK.gaussian_blur_y_planes_reference(a, gn, **kw)
        x_ref = CK.gaussian_blur_x_planes_reference(y_ref, **kw)
        with torch.inference_mode():
            got = (CK.gaussian_blur_y_planes(a, gn, **kw),
                   CK.gaussian_blur_x_planes(y_ref, **kw))
        torch.cuda.synchronize()
        errs = []
        for name, g, w in zip(CK.BLUR_PASSES, got, (y_ref, x_ref)):
            err, ok = CK.max_err_vs_plain(name, g, w)
            rep = crf_report[name]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            errs.append(err)
            if not ok or not torch.equal(g, w):
                raise AssertionError(f"{name} disagrees at {where}: {err} "
                                     f"(max |plain| "
                                     f"{w.float().abs().max().item()})")
        return errs

    def row_kernel_check(a, gn, kw, where):
        """The row kernel (through gaussian_blur_planes' dispatch) against
        the chained plain y and x passes, bit for bit; returns its max abs
        error against the fused plain version."""
        with torch.inference_mode():
            got = CK.gaussian_blur_planes(a, gn, **kw)
        chain = CK.gaussian_blur_x_planes_reference(
            CK.gaussian_blur_y_planes_reference(a, gn, **kw), **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, chain):
            raise AssertionError(
                f"the row kernel differs from the chained passes at {where}:"
                f" {(got.float() - chain.float()).abs().max().item()}")
        err, ok = CK.max_err_vs_plain(
            "gaussian_blur_planes", got,
            CK.gaussian_blur_planes_reference(a, gn, **kw))
        if not ok:
            raise AssertionError(f"gaussian_blur_planes disagrees at {where}"
                                 f": {err}")
        rep = crf_report["gaussian_blur_planes"]
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        return err

    def check_calls(calls, where, names=CK.KERNELS):
        """Each kernel against its plain version on every call of a run
        recorded with the plain versions; a spatial blur outside the row
        kernel's geometry as its y and x passes.  The launches made here do
        not count."""
        saved = counts()
        seen = {}
        for name in names:
            for args, kw, want in calls[name]:
                if name == "gaussian_blur_planes" and not CK.row_kernel_fits(
                        kw["taps"], kw["cs_x"],
                        args[1].shape[0] != kw["ny"] * kw["nx"]):
                    blur_pass_check(*args, kw, where)
                    seen["y and x passes"] = seen.get("y and x passes",
                                                      0) + 1
                    continue
                with torch.inference_mode():
                    got = getattr(CK, name)(*args, **kw)
                torch.cuda.synchronize()
                err, ok = CK.max_err_vs_plain(name, got, want)
                rep = crf_report[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
                if not ok:
                    raise AssertionError(f"{name} disagrees at {where}: "
                                         f"{err}")
                seen[name] = seen.get(name, 0) + 1
        set_counts(saved)
        print(f"    every kernel call against its plain version ({where}): "
              f"{seen} ok")

    def check_blur_passes():
        gen = torch.Generator(dev).manual_seed(SEED + 70)
        for B, ny, nx, cs_y, cs_x, L, sigma, per_image in BLUR_PASS_SHAPES:
            taps = tuple(float(t) for t in DC._gauss_taps(sigma))
            Z, P = ny * nx, cs_y * cs_x
            a = torch.rand((B * Z, L, P), generator=gen, device=dev).to(
                torch.bfloat16)
            gn = 0.5 + torch.rand((B * Z if per_image else Z, 1, P),
                                  generator=gen, device=dev)
            kw = dict(taps=taps, B=B, ny=ny, nx=nx, cs_y=cs_y, cs_x=cs_x)
            where = (B, ny, nx, cs_y, L, sigma)
            before = counts()
            ey, ex = blur_pass_check(a, gn, kw, where)
            moved = {k: v - before[k] for k, v in counts().items() if
                     v != before[k]}
            assert moved == {n: 1 for n in CK.BLUR_PASSES}, moved
            row = ""
            if CK.row_kernel_fits(taps, cs_x, per_image):
                er = row_kernel_check(a, gn, kw, where)
                row = (f"; the row kernel equal to the chained plain passes "
                       f"bit for bit, max_abs {er:.3e} against the fused "
                       f"plain version")
            set_counts(before)
            form = "per image" if per_image else "shared"
            print(f"  {B * Z} cells of {cs_y}x{cs_x}, L={L}, r="
                  f"{len(taps) // 2}, gn {form}: y and x equal to their plain "
                  f"versions bit for bit (max_abs {ey:.3e}, {ex:.3e}){row} ok")
    run.phase("spatial blur: y and x kernels vs plain versions, the row "
              "kernel at the VOC heights", check_blur_passes)

    def voc_scenes(H, W, L, seed, B):
        pairs = [make_scene(H, W, L, seed + k) for k in range(B)]
        return (torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev),
                torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev))

    def voc_batches():
        cfg = CRF.PRODUCTION_CONFIG
        runs = []
        zero_counts()
        for i, (H, W) in enumerate(VOC_SIZES):
            imgs, masks = voc_scenes(H, W, CLASSES, SEED + 800 + 10 * i,
                                     SERVE_B)
            before = counts()
            with torch.inference_mode():
                out = CRF.mean_field_batched(imgs, masks, cfg, CLASSES)
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in counts().items()}
            want = {k: 0 for k in moved}
            want.update(VOC_PER_RUN)
            plan = DC.cell_plan(SERVE_B, H, W, cfg, dev)
            print(f"  ({SERVE_B}, {H}, {W}) at PRODUCTION_CONFIG: cells "
                  f"{plan.cs_y}x{plan.cs_x}, Z = {plan.Z}, splat stride "
                  f"{plan.stride} (the config's {cfg.splat_stride}; "
                  f"{plan.cs_y} {'is odd' if plan.cs_y % 2 else 'is even'}); "
                  f"launches {moved} (want {want})")
            assert moved == want, (moved, want)
            assert out.shape == (SERVE_B, H, W) and out.dtype == torch.int32
            assert out.min() >= 0 and out.max() < CLASSES
            runs.append((H, W, imgs, masks, out))
        saved = counts()
        for H, W, imgs, masks, out in runs:
            with torch.inference_mode(), CK.plain_versions() as calls:
                ref = CRF.mean_field_batched(imgs, masks, cfg, CLASSES)
            agree = (out == ref).float().mean().item()
            moved = (out != masks).float().mean().item()
            print(f"  ({SERVE_B}, {H}, {W}): masks with kernels vs plain "
                  f"versions {agree:.6f} (floor {CRF_PATH_FLOOR}); the CRF "
                  f"changed {moved:.4f} of the pixels")
            assert agree >= CRF_PATH_FLOOR, (H, W, agree)
            check_calls(calls, f"({SERVE_B}, {H}, {W})")
            if (H, W) == VOC_SIZES[0]:
                geo["voc_blur"] = calls["gaussian_blur_planes"][0]
                geo["voc_batch"] = (imgs, masks)
        set_counts(saved)
    run.phase("VOC-size batches: mean_field_batched at (8, 375, 500) and "
              "(8, 500, 375)", voc_batches)

    def voc_do_crf():
        cfg = CRF.CrfConfig()
        cases = []
        for H, W in VOC_SIZES:
            for L in DO_CRF_LABELS:
                im, mask = make_scene(H, W, L, SEED + 900 + H + L)
                cases.append((H, W, L, im, sparse_mask(mask, L, SEED + L)))
        outs = []
        zero_counts()
        for H, W, L, im, mask in cases:
            before = counts()
            out = CRF.do_crf(im, mask, zero_unsure=False, cfg=cfg,
                             device=dev)
            moved = {k: v - before[k] for k, v in counts().items()}
            want = {k: 0 for k in moved}
            want.update(VOC_PER_RUN)
            assert moved == want, (H, W, L, moved, want)
            assert out.shape == mask.shape and out.dtype == mask.dtype
            assert set(np.unique(out)) <= set(np.unique(mask))
            outs.append(out)
        geo["do_crf_launches"] = counts()
        print(f"  do_crf at CrfConfig() on {len(cases)} images ({VOC_SIZES}, "
              f"{DO_CRF_LABELS} labels): launches {counts()}")
        saved = counts()
        for (H, W, L, im, mask), out in zip(cases, outs):
            with CK.plain_versions() as calls:
                ref = CRF.do_crf(im, mask, zero_unsure=False, cfg=cfg,
                                 device=dev)
            a = float((out == ref).mean())
            moved = float((out != mask).mean())
            print(f"  {H}x{W} L={L:2d}: masks with kernels vs plain versions "
                  f"{a:.6f} (floor {CRF_PATH_FLOOR}); the CRF changed "
                  f"{moved:.4f} of the pixels")
            assert a >= CRF_PATH_FLOOR, (H, W, L, a)
            check_calls(calls, f"do_crf {H}x{W} L={L}")
        set_counts(saved)
    run.phase("do_crf at VOC size (375x500, 500x375)", voc_do_crf)

    def resolution_scale():
        cfg = dataclasses.replace(CRF.PRODUCTION_CONFIG, resolution_scale=2)
        reqs = [scene_batch(SERVE_B, SEED + 1000 + 10 * i, "cpu")[0].numpy()
                for i in range(N_REQUESTS)]
        pred = Predictor(net, crf=cfg, compute_dtype="mixed",
                         return_raw=True)
        zero_counts()
        outs = [pred(r) for r in reqs]
        got = counts()
        geo["rs2_launches"] = got
        want = {k: 0 for k in got}
        want["fused_mbconv"] = FUSED_PER_FORWARD * N_REQUESTS
        want["fused_dw_bn_relu6"] = N_REQUESTS
        want.update({n: k * N_REQUESTS for n, k in RS2_PER_REQUEST.items()})
        plan = DC.cell_plan(SERVE_B, SIZE // 2, SIZE // 2, DC._at_scale(cfg),
                            dev)
        print(f"  served {N_REQUESTS} requests of B={SERVE_B} at "
              f"PRODUCTION_CONFIG, resolution_scale 2 (the CRF at "
              f"{SIZE // 2}x{SIZE // 2}, cells {plan.cs_y}x{plan.cs_x}, "
              f"splat stride {plan.stride}): launches {got} (want {want})")
        assert got == want, (got, want)
        for raw, ref in outs:
            for m in (raw, ref):
                assert m.shape == (SERVE_B, SIZE, SIZE) and m.dtype == np.int32
                assert m.min() >= 0 and m.max() < CLASSES
        saved = counts()
        img = torch.from_numpy(reqs[0]).to(dev)
        raw0 = torch.from_numpy(outs[0][0]).to(dev)
        with torch.inference_mode(), CK.plain_versions() as calls:
            ref = CRF.mean_field_batched(img, raw0, cfg, CLASSES)
        agree = float((outs[0][1] == ref.cpu().numpy()).mean())
        moved = float((outs[0][1] != outs[0][0]).mean())
        print(f"  the served CRF vs the same CRF with plain versions: masks "
              f"{agree:.6f} (floor {CRF_PATH_FLOOR}); the CRF changed "
              f"{moved:.4f} of the pixels")
        assert agree >= CRF_PATH_FLOOR
        check_calls(calls, "resolution_scale 2, 32x40 cells")

        xcfg = CRF.CrfConfig(backend="xla", resolution_scale=2)
        im, mask = make_scene(SIZE, SIZE, CLASSES, SEED + 1100)
        mask = sparse_mask(mask, CLASSES, SEED + 1101)
        before = counts()
        out = CRF.do_crf(im, mask, zero_unsure=False, cfg=xcfg, device=dev)
        moved = {k: v - before[k] for k, v in counts().items()}
        want = {k: 0 for k in moved}
        want.update(XLA_PER_IMAGE)
        assert moved == want, (moved, want)
        with CK.plain_versions(CK.XLA_KERNELS) as calls:
            ref = CRF.do_crf(im, mask, zero_unsure=False, cfg=xcfg,
                             device=dev)
        a = float((out == ref).mean())
        print(f"  do_crf, XLA engine, resolution_scale 2, 512x512, 21 "
              f"labels: launches {moved}; masks with kernels vs plain "
              f"versions {a:.6f} (floor {CRF_PATH_FLOOR})")
        assert a >= CRF_PATH_FLOOR
        check_calls(calls, "XLA engine, resolution_scale 2", CK.XLA_KERNELS)

        import os
        golden = np.load(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
            "crf", "s96_21l.npz"))["golden"]
        gim, gmask = make_scene(96, 96, 21, 3)
        gcfg = CRF.CrfConfig(color_step=2.0, splat_stride=2,
                             resolution_scale=2, backend="pallas")
        with torch.inference_mode():
            gout = CRF.mean_field_batched(
                torch.from_numpy(gim)[None].to(dev),
                torch.from_numpy(gmask)[None].to(dev), gcfg, 21)
        a = float((gout[0].cpu().numpy() == golden).mean())
        print(f"  golden s96_21l at color_step 2, splat_stride 2, "
              f"resolution_scale 2: oracle agreement {a:.5f} (floor "
              f"{RS2_GOLDEN_FLOOR})")
        assert a >= RS2_GOLDEN_FLOOR
        set_counts(saved)
    run.phase("resolution_scale 2: Predictor(crf=PRODUCTION_CONFIG at "
              "resolution_scale 2), the XLA engine and the golden",
              resolution_scale)

    def notebook_configs():
        im, mask = make_scene(SIZE, SIZE, 5, SEED + 1200)
        mask = sparse_mask(mask, 5, SEED + 1201)
        for name, cfg, passes in (
                ("CrfConfig(sxy_bilateral=16)",
                 CRF.CrfConfig(sxy_bilateral=16.0), 0),
                ("CrfConfig(sxy_gaussian=8)",
                 CRF.CrfConfig(sxy_gaussian=8.0), 5)):
            zero_counts()
            out = CRF.do_crf(im, mask, zero_unsure=False, cfg=cfg,
                             device=dev)
            got = counts()
            want = {k: 0 for k in got}
            want.update(splat_planes=6, slice_attrs_planes=1,
                        mf_step_planes=5, gaussian_blur_y_planes=passes,
                        gaussian_blur_x_planes=passes)
            if passes:
                geo["wide_launches"] = got
            plan = DC.cell_plan(1, SIZE, SIZE, cfg, dev)
            print(f"  {name} at 512x512, 5 labels: cells {plan.cs_y}x"
                  f"{plan.cs_x}, Z = {plan.Z}, spatial radius "
                  f"{len(DC._gauss_taps(cfg.sxy_gaussian)) // 2}; launches "
                  f"{got} (want {want})")
            assert got == want, (name, got, want)
            assert out.shape == mask.shape and out.dtype == mask.dtype
            saved = counts()
            with CK.plain_versions() as calls:
                ref = CRF.do_crf(im, mask, zero_unsure=False, cfg=cfg,
                                 device=dev)
            a = float((out == ref).mean())
            print(f"  {name}: masks with kernels vs plain versions {a:.6f} "
                  f"(floor {CRF_PATH_FLOOR}); the CRF changed "
                  f"{float((out != mask).mean()):.4f} of the pixels")
            assert a >= CRF_PATH_FLOOR
            check_calls(calls, name)
            set_counts(saved)
    run.phase("the notebook's CrfConfig(sxy_bilateral=16) and "
              "CrfConfig(sxy_gaussian=8) through do_crf", notebook_configs)

    # 5. the Xception path and the subpixel head --------------------------
    def record_sepconv(xnet, img, policy):
        """Every fused_sepconv call of one forward, with the plain version
        in the kernel's place: {(Cin, Cout, rate, H, W, pre_relu, act):
        [weights, keyword arguments, calls]} in graph order."""
        calls = {}
        kernel = FM.fused_sepconv

        def record(x, *w, **kw):
            _, H, W, cin = x.shape
            key = (cin, w[2].shape[1], kw["rate"], H, W, kw["pre_relu"],
                   kw["act_out"])
            calls.setdefault(key, [w, kw, 0])[2] += 1
            return FM.fused_sepconv_reference(x, *w, **kw)
        FM.fused_sepconv = record
        try:
            xnet.logits(img, policy)
        finally:
            FM.fused_sepconv = kernel
        return calls

    def sepconv_label(key):
        cin, cout, rate, H, W, pre, act = key
        return (f"{cin}->{cout} rate {rate} {H}x{W} pre_relu {int(pre)} "
                f"act {int(act)}")

    def xception_setup():
        xnet = seeded_net((SIZE, SIZE), SEED + 6, dev, "xception",
                          "original", XCEPTION_OS, var_floor=0.1)
        gen = torch.Generator(dev).manual_seed(SEED + 7)
        img = torch.rand((2, SIZE, SIZE, 3), generator=gen, device=dev) * 255
        calls = record_sepconv(xnet, img, "mixed")
        n = sum(c[2] for c in calls.values())
        print(f"  {len(calls)} distinct fused_sepconv shapes, {n} calls per "
              f"forward (want {SEPCONV_PER_FORWARD}):")
        for key, c in calls.items():
            print(f"    {sepconv_label(key)} x{c[2]}")
        assert n == SEPCONV_PER_FORWARD, n
        xc.update(net=xnet, calls=calls)
    run.phase(f"seeded 512x512 Xception net (OS {XCEPTION_OS})",
              xception_setup)

    def check_sepconv():
        gen = torch.Generator(dev).manual_seed(SEED + 8)
        worst = 0.0
        for pol_name, B in (("mixed", 2), ("bfloat16", 2),
                            ("mixed", SERVE_B)):
            pol = core.resolve_compute_dtype(pol_name)
            for key, (w, kw, _) in xc["calls"].items():
                cin, _, _, H, W = key[:5]
                x = torch.randn((B, H, W, cin), generator=gen,
                                device=dev).to(pol.dtype)
                kw = dict(kw, mxu_bf16=pol.mxu_bf16)
                got = FM.fused_sepconv(x, *w, **kw)
                ref = FM.fused_sepconv_reference(x, *w, **kw)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                rel = err / max(scale, 1e-30)
                tol = KERNEL_REL_TOL[pol_name]
                ok = math.isfinite(err) and rel <= tol
                print(f"  {pol_name:8s} {sepconv_label(key)} B={B}: max_abs "
                      f"{err:.3e} max|ref| {scale:.3e} rel {rel:.3e} (tol "
                      f"{tol}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"fused_sepconv disagrees at {key}")
                worst = max(worst, err)
        sepconv_report["max_abs_err"] = worst
    run.phase("fused_sepconv vs plain version", check_sepconv)

    def serve_xception():
        xnet = xc["net"]
        gen = torch.Generator().manual_seed(SEED + 9)
        reqs = [(torch.rand((SERVE_B, SIZE, SIZE, 3), generator=gen) * 255)
                .numpy() for _ in range(N_REQUESTS)]
        pred = Predictor(xnet, compute_dtype="mixed")
        zero_counts()
        masks = [pred(r) for r in reqs]
        got = counts()
        sepconv_report["launches"] = got["fused_sepconv"]
        want = {k: 0 for k in got}
        want["fused_sepconv"] = SEPCONV_PER_FORWARD * N_REQUESTS
        print(f"  served {N_REQUESTS} requests of B={SERVE_B}: launches "
              f"{got} (want {want})")
        assert got == want, (got, want)
        for m in masks:
            assert m.shape == (SERVE_B, SIZE, SIZE) and m.dtype == np.int32
            assert m.min() >= 0 and m.max() < CLASSES
        print(f"  classes present in the masks: "
              f"{len(np.unique(np.concatenate(masks)))}")

        img = torch.from_numpy(reqs[0]).to(dev)
        fused = xnet.logits(img, "mixed").float()
        assert torch.isfinite(fused).all()
        kernel = FM.fused_sepconv
        FM.fused_sepconv = FM.fused_sepconv_reference
        try:
            in_situ = xnet.logits(img, "mixed").float()
        finally:
            FM.fused_sepconv = kernel
        xnet.fuse_blocks = False
        try:
            plain = xnet.logits(img, "mixed").float()
            f32 = xnet.logits(img, "float32").float()
        finally:
            xnet.fuse_blocks = True
        scale = f32.abs().max().item()
        err_k = (fused - in_situ).abs().max().item()
        err_kf = (fused - f32).abs().max().item()
        err_pf = (plain - f32).abs().max().item()
        print(f"  B={SERVE_B}, mixed, max|logit| {scale:.4e}:")
        print(f"    kernel path vs plain version in its place: max_abs "
              f"{err_k:.4e} (rel tol {KERNEL_PATH_REL_TOL}), argmax agreement "
              f"{agree(fused, in_situ):.5f} (floor {KERNEL_PATH_FLOOR})")
        print(f"    against float32: kernel path max_abs {err_kf:.4e}, "
              f"argmax agreement {agree(fused, f32):.5f}; plain composition "
              f"max_abs {err_pf:.4e}, agreement {agree(plain, f32):.5f} "
              f"(kernel path at most {SEPCONV_F32_RATIO}x as far, agreement "
              f"trailing by at most {F32_AGREE_MARGIN})")
        assert err_k <= KERNEL_PATH_REL_TOL * scale
        assert agree(fused, in_situ) >= KERNEL_PATH_FLOOR
        assert err_kf <= SEPCONV_F32_RATIO * err_pf
        assert agree(fused, f32) >= agree(plain, f32) - F32_AGREE_MARGIN

        # one request through the production CRF: the CRF is net-agnostic
        pred = Predictor(xnet, crf=CRF.PRODUCTION_CONFIG,
                         compute_dtype="mixed", return_raw=True)
        req = scene_batch(SERVE_B, SEED + 600, "cpu")[0].numpy()
        zero_counts()
        raw, refined = pred(req)
        got = counts()
        want = {k: 0 for k in got}
        want["fused_sepconv"] = SEPCONV_PER_FORWARD
        want.update(CRF_PER_REQUEST)
        print(f"  one request of B={SERVE_B} at PRODUCTION_CONFIG: launches "
              f"{got} (want {want}); the CRF changed "
              f"{(raw != refined).mean():.4f} of the pixels")
        assert got == want, (got, want)
        for m in (raw, refined):
            assert m.shape == (SERVE_B, SIZE, SIZE) and m.dtype == np.int32
            assert m.min() >= 0 and m.max() < CLASSES
    run.phase("Xception path: Predictor(mixed) and Predictor(crf=PRODUCTION_"
              "CONFIG) serving", serve_xception)

    def serve_subpixel():
        snet = seeded_net((SIZE, SIZE), SEED + 11, dev, "mobilenetv2",
                          "subpixel")
        gen = torch.Generator().manual_seed(SEED + 12)
        req = (torch.rand((SERVE_B, SIZE, SIZE, 3), generator=gen) * 255
               ).numpy()
        pred = Predictor(snet, compute_dtype="mixed")
        zero_counts()
        m = pred(req)
        got = counts()
        want = {k: 0 for k in got}
        want["fused_mbconv"] = FUSED_PER_FORWARD
        want["fused_dw_bn_relu6"] = 1
        print(f"  served one request of B={SERVE_B}: launches {got} (want "
              f"{want})")
        assert got == want, (got, want)
        assert m.shape == (SERVE_B, SIZE, SIZE) and m.dtype == np.int32
        assert m.min() >= 0 and m.max() < CLASSES
        img = torch.from_numpy(req).to(dev)
        fused = snet.logits(img, "mixed").float()
        with model_plain_versions():
            in_situ = snet.logits(img, "mixed").float()
        scale = snet.logits(img, "float32").abs().max().item()
        err = (fused - in_situ).abs().max().item()
        print(f"  kernel path vs plain version in its place: max_abs "
              f"{err:.4e}, max|float32 logit| {scale:.4e} (rel tol "
              f"{KERNEL_PATH_REL_TOL}), argmax agreement "
              f"{agree(fused, in_situ):.5f} (floor {KERNEL_PATH_FLOOR}); "
              f"{len(np.unique(m))} classes in the masks")
        assert torch.isfinite(fused).all()
        assert err <= KERNEL_PATH_REL_TOL * scale
        assert agree(fused, in_situ) >= KERNEL_PATH_FLOOR
    run.phase("subpixel head: Predictor(SegNet(mobilenetv2, subpixel), mixed)",
              serve_subpixel)

    # 10. the serving surface ---------------------------------------------
    def tta_serving():
        cfg = CRF.PRODUCTION_CONFIG
        kw = dict(tta_scales=TTA_SCALES, tta_flip=True)
        pred = Predictor(net, crf=cfg, compute_dtype="mixed",
                         return_raw=True, **kw)
        print(f"  twins {[m.sz for m in pred.twins]}, flips {pred.flips}")
        # a batch of seeded scenes, then seeded noise (the scenes' smooth
        # regions leave the averaged argmax few classes for the CRF to move)
        gen = torch.Generator().manual_seed(SEED + 710)
        reqs = [scene_batch(SERVE_B, SEED + 700, "cpu")[0].numpy()] + [
            (torch.rand((SERVE_B, SIZE, SIZE, 3), generator=gen) * 255
             ).numpy() for _ in range(TTA_REQUESTS - 1)]
        zero_counts()
        outs = [pred(r) for r in reqs]
        got = counts()
        want = {k: 0 for k in got}
        want.update({n: k * TTA_REQUESTS for n, k in TTA_PER_REQUEST.items()})
        print(f"  {TTA_REQUESTS} TTA requests of B={SERVE_B} with the CRF: "
              f"launches {got} (want {want})")
        assert got == want, (got, want)
        with model_plain_versions(), CK.plain_versions():
            plain = [pred(r) for r in reqs]
        for (raw, ref), (p_raw, p_ref) in zip(outs, plain):
            for m in (raw, ref):
                assert m.shape == (SERVE_B, SIZE, SIZE) and m.dtype == np.int32
                assert m.min() >= 0 and m.max() < CLASSES
            a_raw = float((raw == p_raw).mean())
            a_ref = float((ref == p_ref).mean())
            print(f"  kernels vs plain versions: raw argmax {a_raw:.6f} "
                  f"(floor {KERNEL_PATH_FLOOR}), CRF masks {a_ref:.6f} "
                  f"(floor {CRF_PATH_FLOOR}); {len(np.unique(raw))} classes "
                  f"present, the CRF changed {(raw != ref).mean():.6f} of "
                  f"the pixels")
            assert a_raw >= KERNEL_PATH_FLOOR and a_ref >= CRF_PATH_FLOOR
        img = torch.from_numpy(reqs[0]).to(dev)
        ms = cuda_ms(lambda: pred._run(img), 5, warmup=1)
        t0 = time.perf_counter()
        for _ in range(3):
            pred(reqs[0])
        host = (time.perf_counter() - t0) / 3 * 1e3
        serving.update(tta_ms=ms, tta_host_ms=host)
        print(f"  TTA {TTA_SCALES} x flip + CRF per B={SERVE_B} request: "
              f"{ms:.3f} ms (CUDA events, on the card's input), {host:.3f} "
              f"ms (host clock, numpy in and out) [{card}]")

        xpred = Predictor(xc["net"], compute_dtype="mixed", **kw)
        req = scene_batch(SERVE_B, SEED + 750, "cpu")[0].numpy()
        zero_counts()
        m = xpred(req)
        got = counts()
        want = {k: 0 for k in got}
        want["fused_sepconv"] = TTA_XCEPTION_SEPCONV
        print(f"  one Xception TTA request of B={SERVE_B}, model only: "
              f"launches {got} (want {want})")
        assert got == want, (got, want)
        assert m.shape == (SERVE_B, SIZE, SIZE) and m.max() < CLASSES
    run.phase("serving surface: Predictor(crf=PRODUCTION_CONFIG, mixed, "
              "tta_scales, tta_flip)", tta_serving)

    def dispatcher_load():
        import collections
        import threading
        from deeplab_tpu_torch.serve import _Dispatcher
        cfg = CRF.PRODUCTION_CONFIG
        pred = Predictor(net, crf=cfg, compute_dtype="mixed")
        base = scene_batch(DISPATCH_CLIENTS, SEED + 800, "cpu")[0].numpy()
        n = DISPATCH_CLIENTS
        imgs = [np.roll(base[i % n], 7 * (i // n), axis=1)
                for i in range(DISPATCH_REQUESTS)]
        direct = np.concatenate([
            pred(np.stack(imgs[i:i + DISPATCH_MAX_BATCH]))
            for i in range(0, DISPATCH_REQUESTS, DISPATCH_MAX_BATCH)])
        b = 1
        while b <= DISPATCH_MAX_BATCH:          # every bucket, warm
            pred(np.stack(imgs[:b]))
            b *= 2
        seen, sizes = [], []
        hook = net.Conv.register_forward_pre_hook(
            lambda mod, args: seen.append((
                threading.get_ident(), torch.is_inference_mode_enabled(),
                torch.cuda.current_stream().cuda_stream)))

        def pipeline(batch):
            sizes.append(batch.shape[0])
            return pred(batch)
        d = _Dispatcher(pipeline, DISPATCH_MAX_BATCH, DISPATCH_WAIT_MS)
        masks = [None] * DISPATCH_REQUESTS
        lat = [0.0] * DISPATCH_REQUESTS

        def client(c):
            for i in range(c, DISPATCH_REQUESTS, DISPATCH_CLIENTS):
                t = time.perf_counter()
                masks[i] = d.submit(imgs[i])
                lat[i] = (time.perf_counter() - t) * 1e3
        try:
            zero_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(DISPATCH_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            got = counts()
        finally:
            d.shutdown()
            hook.remove()
        calls = len(sizes)
        want = {k: 0 for k in got}
        want["fused_mbconv"] = FUSED_PER_FORWARD * calls
        want["fused_dw_bn_relu6"] = calls
        want.update({n: k * calls for n, k in CRF_PER_REQUEST.items()})
        print(f"  {DISPATCH_REQUESTS} requests from {DISPATCH_CLIENTS} "
              f"clients, max_batch {DISPATCH_MAX_BATCH}, max_wait "
              f"{DISPATCH_WAIT_MS} ms: {calls} device calls, batch sizes "
              f"{dict(sorted(collections.Counter(sizes).items()))}; "
              f"launches {got} (want {want})")
        assert got == want, (got, want)
        threads_seen = {r[0] for r in seen}
        modes = sorted({r[1] for r in seen})
        print(f"  the model ran on threads {threads_seen} (the dispatcher's "
              f"{d.thread.ident}), inference mode {modes}, streams "
              f"{sorted({r[2] for r in seen})}")
        assert threads_seen == {d.thread.ident} and len(seen) == calls
        assert all(r[1] for r in seen)
        assert {r[2] for r in seen} == {torch.cuda.current_stream(
            ).cuda_stream}
        worst = min(float((m == direct[i]).mean())
                    for i, m in enumerate(masks))
        lat_s = sorted(lat)
        p50 = lat_s[len(lat_s) // 2]
        p99 = lat_s[min(len(lat_s) - 1, int(0.99 * len(lat_s)))]
        serving.update(rps=DISPATCH_REQUESTS / wall, p50_ms=p50, p99_ms=p99,
                       batches=dict(collections.Counter(sizes)))
        print(f"  masks vs a direct Predictor call: worst agreement "
              f"{worst:.6f} (floor {DISPATCH_FLOOR})")
        print(f"  dispatcher at {DISPATCH_CLIENTS} clients: "
              f"{DISPATCH_REQUESTS / wall:.1f} requests/s, latency p50 "
              f"{p50:.1f} ms, p99 {p99:.1f} ms (host clock) [{card}]")
        assert worst >= DISPATCH_FLOOR

        try:
            import PIL  # noqa: F401 -- a host decoder the card may lack
        except ImportError:
            print("  HTTP round trip: not run (PIL does not import here)")
            return
        import io
        import urllib.request
        from PIL import Image
        from deeplab_tpu_torch.serve import BatchingServer, _decode_bgr
        buf = io.BytesIO()
        Image.fromarray(imgs[0][..., ::-1].astype(np.uint8)).save(
            buf, format="PNG")
        srv = BatchingServer(pred, (SIZE, SIZE), max_batch=DISPATCH_MAX_BATCH,
                             max_wait_ms=DISPATCH_WAIT_MS)
        port = srv.start(port=0)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                mask = np.asarray(Image.open(io.BytesIO(r.read())))
                classes = r.headers["X-Classes"]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=30) as r:
                health = json.loads(r.read())
        finally:
            srv.stop()
        want = pred(_decode_bgr(buf.getvalue(), (SIZE, SIZE))[None])[0]
        a = float((mask == want).mean())
        print(f"  HTTP round trip through BatchingServer: ran; mask "
              f"{mask.shape}, classes {classes}, agreement with a direct "
              f"call {a:.6f}; healthz {health['status']}")
        assert mask.shape == (SIZE, SIZE) and a >= DISPATCH_FLOOR
    run.phase("serving surface: _Dispatcher under load and BatchingServer "
              "over HTTP", dispatcher_load)

    def xception_times():
        xnet = xc["net"]
        gen = torch.Generator(dev).manual_seed(SEED + 13)
        saved = counts()
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "composition_ms": 0.0}
        by = {"bytes": 0.0, "operations": 0.0}
        per_shape = []
        for key, (w, kw, n) in xc["calls"].items():
            cin, cout, rate, H, W, pre, act = key
            x = torch.randn((SERVE_B, H, W, cin), generator=gen, device=dev)
            with torch.inference_mode():
                ms = cuda_ms(lambda: FM.fused_sepconv(x, *w, **kw), 20)
                plain = cuda_ms(lambda: FM.fused_sepconv_reference(
                    x, *w, **kw), 5, warmup=1)
                comp = cuda_ms(sepconv_composition(x, w, rate, pre, act), 20)
            bms, bb = sepconv_bound_ms(SERVE_B, H, W, cin, cout, 4)
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain
            tot["bound_ms"] += n * bms
            tot["composition_ms"] += n * comp
            by[bb] += n * bms
            per_shape.append((n * ms, key, n))
            print(f"  fused_sepconv {sepconv_label(key)} x{n} B={SERVE_B} f32 "
                  f"io: kernel {ms:.4f} ms, plain {plain:.4f} ms, composition "
                  f"{comp:.4f} ms, bound {bms:.4f} ms ({bb}), "
                  f"{bms / ms:.3f} of bound [{card}]")
        print(f"  per forward ({SEPCONV_PER_FORWARD} launches, B={SERVE_B}): "
              f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
              f"composition {tot['composition_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms [{card}]")
        for t, key, n in sorted(per_shape, key=lambda r: -r[0])[:4]:
            print(f"    slowest: {sepconv_label(key)} x{n}: {t:.4f} ms per "
                  f"forward")
        sepconv_report.update(tot)
        sepconv_report["bound_by"] = max(by, key=by.get)

        img = torch.rand((BENCH_B, SIZE, SIZE, 3), generator=gen, device=dev
                         ) * 255
        for what, fuse, policy in (("mixed, fused_sepconv", True, "mixed"),
                                   ("mixed, plain layer composition", False,
                                    "mixed"),
                                   ("float32", True, "float32")):
            xnet.fuse_blocks = fuse
            ms = cuda_ms(lambda: xnet.predict_ids(img, policy), 10, warmup=2)
            print(f"  Xception model-only {what} B={BENCH_B}: {ms:.3f} "
                  f"ms/batch, {1e3 * BENCH_B / ms:.1f} img/s [{card}]")
        xnet.fuse_blocks = True
        set_counts(saved)
    run.phase("Xception times", xception_times)
    xc.clear()   # the later phases' peak device memory is their own

    # 6. training ---------------------------------------------------------
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
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "composition_ms": 0.0}
            by = {"bytes": 0.0, "operations": 0.0}
            for args, kw, want in calls[name]:
                with torch.no_grad():
                    ms = cuda_ms(lambda: kernel(*args, **kw), 10)
                    plain = cuda_ms(lambda: ref(*args, **kw), 2, warmup=1)
                    comp = (cuda_ms(train_composition(name, args), 10)
                            if name in ("f1", "f3") else 0.0)
                bms, bb = train_bound_ms(name, args, want)
                tot["ms"] += ms
                tot["plain_ms"] += plain
                tot["bound_ms"] += bms
                tot["composition_ms"] += comp
                by[bb] += bms
                print(f"  {name:4s} {label(args)}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms, bound {bms:.4f} ms ({bb}), "
                      f"{bms / ms:.3f} of bound"
                      + (f", composition {comp:.4f} ms" if comp else "")
                      + f" [{card}]")
            train_report[name].update(tot)
            train_report[name]["bound_by"] = max(by, key=by.get)
            print(f"  {name} per step (14 launches, B={TRAIN_B}): kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
                  f"{tot['bound_ms']:.4f} ms"
                  + (f", composition {tot['composition_ms']:.4f} ms"
                     if name in ("f1", "f3") else "") + f" [{card}]")
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

    # 7. times -----------------------------------------------------------
    def times():
        gen = torch.Generator().manual_seed(SEED + 4)
        pol = core.resolve_compute_dtype("mixed")
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        bound_by = {"bytes": 0.0, "operations": 0.0}
        tot["composition_ms"] = tot["device_ms"] = 0.0
        for ids, cin, ce, cout, rate, skip, st in shapes:
            H = W = SIZE // st
            x, w, mxu = block_inputs(ids, cin, H, W, SERVE_B, pol, gen)
            counted = FM.fused_mbconv.launches
            ms = cuda_ms(lambda: FM.fused_mbconv(
                x, *w, rate=rate, skip=skip, mxu_bf16=mxu), 20)
            FM.fused_mbconv.launches = counted  # timing launches do not count
            plain = cuda_ms(lambda: FM.fused_mbconv_reference(
                x, *w, rate=rate, skip=skip, mxu_bf16=mxu), 10)
            dev_ms = graph_ms(lambda: FM.fused_mbconv(
                x, *w, rate=rate, skip=skip, mxu_bf16=mxu))
            FM.fused_mbconv.launches = counted
            comp = cuda_ms(mbconv_composition(x, w, rate, skip), 20)
            bms, by = bound_ms(SERVE_B, H, W, cin, ce, cout, 4)
            plan = FM.mbconv_plan(SERVE_B, H, W, cin, ce, cout, rate)
            n = len(ids)
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain
            tot["bound_ms"] += n * bms
            tot["composition_ms"] += n * comp
            tot["device_ms"] += n * dev_ms
            bound_by[by] += n * bms
            print(f"  fused_mbconv blocks {ids} {cin}->{ce}->{cout} rate "
                  f"{rate} B={SERVE_B} {H}x{W} f32 io: kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f} ms in a CUDA graph), plain "
                  f"{plain:.4f} ms, composition {comp:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}), {bms / ms:.3f} of bound; plan "
                  f"{plan.th}x{plan.tw} tiles, chunk {plan.ck}, "
                  f"{plan.stages} stages, grid {plan.grid}, "
                  f"{plan.smem} B shared, halo {plan.halo:.3f}x [{card}]")
        print(f"  per forward (14 launches, B={SERVE_B}): kernel "
              f"{tot['ms']:.4f} ms (device {tot['device_ms']:.4f} ms), plain "
              f"{tot['plain_ms']:.4f} ms, "
              f"composition {tot['composition_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms [{card}]")
        kernel_report.update(tot)
        kernel_report["bound_by"] = max(bound_by, key=bound_by.get)

        img = (torch.rand((BENCH_B, SIZE, SIZE, 3), generator=gen) * 255
               ).to(dev)
        for what, fuse, policy in (("mixed", True, "mixed"),
                                   ("mixed, plain layer composition", False,
                                    "mixed"),
                                   ("float32", True, "float32")):
            counted = FM.fused_mbconv.launches
            dw = FDW.fused_dw_bn_relu6.launches
            net.fuse_blocks = fuse
            ms = cuda_ms(lambda: net.predict_ids(img, policy), 10, warmup=2)
            net.fuse_blocks = True
            FM.fused_mbconv.launches = counted
            FDW.fused_dw_bn_relu6.launches = dw
            print(f"  model-only {what} B={BENCH_B}: {ms:.3f} ms/batch, "
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
            tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0}
            by = {"bytes": 0.0, "operations": 0.0}
            for idx, n in ks:
                args, kw, out = crf_b8[name][idx]
                with torch.inference_mode():
                    ms = cuda_ms(lambda: kernel(*args, **kw), 20)
                    dev_ms = graph_ms(lambda: kernel(*args, **kw))
                    plain = cuda_ms(lambda: ref(*args, **kw), 3, warmup=1)
                bms, bb = crf_bound_ms(CK, name, args, kw, out)
                tot["ms"] += n * ms
                tot["device_ms"] += n * dev_ms
                tot["plain_ms"] += n * plain
                tot["bound_ms"] += n * bms
                by[bb] += n * bms
                shapes = [tuple(t.shape) for t in tensors(args)]
                print(f"  {name} launch {idx} (x{n} per request) inputs "
                      f"{shapes}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms "
                      f"in a CUDA graph), plain {plain:.4f} ms, "
                      f"bound {bms:.4f} ms ({bb}), {bms / ms:.3f} of bound "
                      f"[{card}]")
            crf_report[name].update(tot)
            crf_report[name]["bound_by"] = max(by, key=by.get)
            crf_report[name]["library_ms"] = None
            print(f"  {name} per request (B={SERVE_B}): kernel "
                  f"{tot['ms']:.4f} ms (device {tot['device_ms']:.4f} ms), "
                  f"plain {tot['plain_ms']:.4f} ms, bound "
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

        # the splat and the step on structured, flat and noise scenes
        scenes = crf_scene_times(card)
        crf_report["splat_planes"]["scenes"] = {
            k: {"norm_ms": v["splat_norm"]["ms"],
                "norm_device_ms": v["splat_norm"]["device_ms"],
                "iteration_ms": v["splat_iter"]["ms"],
                "iteration_device_ms": v["splat_iter"]["device_ms"]}
            for k, v in scenes.items()}
        crf_report["mf_step_planes"]["scenes"] = {
            k: {"ms": v["step"]["ms"], "device_ms": v["step"]["device_ms"],
                "two_kernel_device_ms": v["step"]["two_kernel_ms"]}
            for k, v in scenes.items()}
        cfg = CRF.PRODUCTION_CONFIG
        img8, m8 = scene_batch(SERVE_B, SEED + 200, dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: CRF.mean_field_batched(img8, m8, cfg,
                                                        CLASSES), 10,
                         warmup=2)
        print(f"  CRF alone (mean_field_batched, PRODUCTION_CONFIG) B="
              f"{SERVE_B}: {ms:.3f} ms/batch, {1e3 * SERVE_B / ms:.1f} img/s "
              f"[{card}]")
        # where the CRF's device time goes
        device_table(lambda: CRF.mean_field_batched(img8, m8, cfg, CLASSES),
                     f"CRF B={SERVE_B}")
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
    def geometry_times():
        """The row kernel on the recorded (8, 375, 500) blur input and the y
        and x kernels launched directly on the same input, each beside its
        bound, plain version and one depthwise F.conv2d; the passes at r =
        20 on (8, 512, 512) in 64x128 cells; the CRF per (8, 375, 500)
        batch; production end to end at resolution_scale 2."""
        if "voc_blur" not in geo:
            raise RuntimeError("no (8, 375, 500) blur call recorded")
        (a, gn), kw, _ = geo["voc_blur"]
        saved = counts()
        voc = blur_times(CK, a, gn, kw, card)
        ys, xs = (voc[n]["ms"] for n in CK.BLUR_PASSES)
        print(f"  the blur at (8, 375, 500): y + x {ys + xs:.4f} ms per "
              f"iteration against the row kernel, which the dispatch now "
              f"runs there, {voc['rows']['ms']:.4f} ms [{card}]")
        crf_report["gaussian_blur_planes"]["voc_ms"] = voc["rows"]["ms"]
        # the passes' own radius (the path sends them r > 16) is their
        # headline; r = 8 on the VOC input is a direct launch no path makes
        wide = blur_times(CK, *wide_blur_input(dev), card, rows=False)
        for name in CK.BLUR_PASSES:
            crf_report[name].update(wide[name])
            crf_report[name]["voc_r8"] = voc[name]
        imgs, masks = geo["voc_batch"]
        cfg = CRF.PRODUCTION_CONFIG
        with torch.inference_mode():
            ms = cuda_ms(lambda: CRF.mean_field_batched(imgs, masks, cfg,
                                                        CLASSES), 5, warmup=1)
        print(f"  mean_field_batched PRODUCTION_CONFIG ({SERVE_B}, 375, 500):"
              f" {ms:.3f} ms/batch, {1e3 * SERVE_B / ms:.1f} img/s [{card}]")
        device_table(lambda: CRF.mean_field_batched(imgs, masks, cfg,
                                                    CLASSES),
                     f"CRF ({SERVE_B}, 375, 500)")
        rs2 = dataclasses.replace(cfg, resolution_scale=2)
        img8, m8 = scene_batch(SERVE_B, SEED + 200, dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: CRF.mean_field_batched(img8, m8, rs2,
                                                        CLASSES), 10,
                         warmup=2)
        print(f"  CRF alone at resolution_scale 2, B={SERVE_B} 512x512: "
              f"{ms:.3f} ms/batch [{card}]")
        device_table(lambda: CRF.mean_field_batched(img8, m8, rs2, CLASSES),
                     f"CRF at resolution_scale 2, B={SERVE_B}")
        img16 = scene_batch(BENCH_B, SEED + 300, dev)[0]

        def production(c):
            ids = net.predict_ids(img16, "mixed")
            return CRF.mean_field_batched(img16, ids, c, CLASSES)
        with torch.inference_mode():
            for label, c in (("resolution_scale 2", rs2),
                             ("resolution_scale 1", cfg)):
                ms = cuda_ms(lambda: production(c), 5, warmup=2)
                print(f"  production end to end (model mixed + CRF at "
                      f"{label}) B={BENCH_B}: {ms:.3f} ms/batch, "
                      f"{1e3 * BENCH_B / ms:.1f} img/s [{card}]")
        set_counts(saved)
    run.phase("CRF geometry times", geometry_times)
    run.phase("training times", train_times)

    if run.failed:
        print(f"FAILED phases: {run.failed}")
        return 1
    # launches: from the main path's run (fused_sepconv: the Xception
    # path's; slice_planes: the XLA engine's do_crf runs; the y and x
    # passes: do_crf at CrfConfig(sxy_gaussian=8)); times: per request at
    # B=8 (slice_planes: per XLA-engine do_crf image; the passes: per
    # launch at r = 20 on (8, 512, 512), and at r = 8 on the (8, 375, 500)
    # shapes, launched directly, under "voc_r8")
    launches = crf_report["launches"]
    line = [{
        "name": "fused_mbconv", "route": "cuda",
        "source": "deeplab_tpu_torch/kernels/csrc/fused_mbconv.cu",
        "replaces": "deeplab_tpu/kernels/fused_mbconv.py:121",
        "launches": launches["fused_mbconv"],
        "max_abs_err": kernel_report["max_abs_err"],
        "ms": kernel_report["ms"], "plain_ms": kernel_report["plain_ms"],
        "bound_ms": kernel_report["bound_ms"],
        "bound_by": kernel_report["bound_by"], "library_ms": None,
        "composition_ms": kernel_report["composition_ms"],
        "device_ms": kernel_report["device_ms"]}, {
        "name": "fused_sepconv", "route": "cuda",
        "source": "deeplab_tpu_torch/kernels/csrc/fused_sepconv.cu",
        "replaces": "deeplab_tpu/kernels/fused_mbconv.py:208",
        "launches": sepconv_report["launches"],
        "max_abs_err": sepconv_report["max_abs_err"],
        "ms": sepconv_report["ms"], "plain_ms": sepconv_report["plain_ms"],
        "bound_ms": sepconv_report["bound_ms"],
        "bound_by": sepconv_report["bound_by"], "library_ms": None,
        "composition_ms": sepconv_report["composition_ms"]}, {
        "name": "fused_dw_bn_relu6", "route": "cuda",
        "source": "deeplab_tpu_torch/kernels/csrc/fused_dw.cu",
        "replaces": "deeplab_tpu/kernels/fused_dw.py:66",
        "launches": launches["fused_dw_bn_relu6"],
        "max_abs_err": dw_report["max_abs_err"], "ms": dw_report["ms"],
        "plain_ms": dw_report["plain_ms"], "bound_ms": dw_report["bound_ms"],
        "bound_by": dw_report["bound_by"], "library_ms": None,
        "composition_ms": dw_report["composition_ms"],
        "device_ms": dw_report["device_ms"]}]
    for n in CRF_KERNELS:
        rep = crf_report[n]
        entry = {
            "name": n, "route": "cuda",
            "source": "deeplab_tpu_torch/kernels/csrc/crf_fused.cu",
            "replaces": f"deeplab_tpu/kernels/crf_fused.py:{CRF_REPLACES[n]}",
            "launches": (notebook["launches"][n] if n == "slice_planes"
                         else geo["wide_launches"][n] if n in CK.BLUR_PASSES
                         else launches[n]),
            "max_abs_err": rep["max_abs_err"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"]}
        if n in CK.BLUR_PASSES:
            entry["voc_r8"] = rep["voc_r8"]
        if n == "gaussian_blur_planes":
            entry["voc_ms"] = rep["voc_ms"]
        if "device_ms" in rep:
            entry["device_ms"] = rep["device_ms"]
        if "scenes" in rep:
            entry["scenes"] = rep["scenes"]
        if n == "mf_step_planes":
            ut = notebook["unary_times"]
            entry["forms"] = {
                "labels": launches[n],
                "explicit_unary": notebook["launches"][n],
                "explicit_unary_ms_per_image": ut["ms"],
                "explicit_unary_bound_ms": ut["bound_ms"],
                "explicit_unary_plain_ms": ut["plain_ms"]}
        line.append(entry)
    # training phases: launches from the training run, times per step at B=16
    for n in FMT.PHASES:
        rep = train_report[n]
        entry = {
            "name": f"block_train_{n}", "route": "cuda",
            "source": "deeplab_tpu_torch/kernels/csrc/fused_mbconv_train.cu",
            "replaces": "deeplab_tpu/kernels/fused_mbconv_train.py:"
                        f"{FMT.REPLACES[n]}",
            "launches": train["launches"]["train_" + n],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": None}
        if n in ("f1", "f3"):
            entry["composition_ms"] = rep["composition_ms"]
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
