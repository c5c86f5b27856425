"""What every cell of the benchmark shares: finding its files by name, the
seeded inputs and weights, the control's precision, the traced sub-window
and the reading of the trace.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its files are
found by name, so a cell, a configuration, a traffic kind or a per-layer
metric is added by adding files:

- ``configs/<config>.json``: the model configuration (widths, policy, CRF);
- ``workloads/<traffic>.json``: the traffic mix (``kind``, its parameters,
  the limits of the cell's compared numbers);
- ``traffic/<kind>.py``: the generator and driver of one kind of traffic;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports the program under test at module level; the traffic
kinds import ``deeplab_tpu_torch`` when they build it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplab_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


# ------------------------------------------------------------ registry ----

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def load_module(kind: str, name: str, root: str = ROOT):
    """``portbench/<kind>/<name>.py`` under ``root`` as a module (names may
    hold dots)."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    if not os.path.exists(path):
        raise BenchError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, cell: str, root: str = ROOT):
    """(BENCHMARK entry, workload file, config file) of ``cell``."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise BenchError(f"no workload {cell!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    workload = load_json(os.path.join(root, "portbench", "workloads",
                                      entry["traffic"] + ".json"))
    config = load_json(os.path.join(root, cfg_entry["file"]))
    return entry, workload, config


def metrics_of(bench: dict, cell: str, section: str):
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


# -------------------------------------------------------------- seeds ----

def rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 64),
                                  zlib.crc32(stream.encode())])


def torch_seed(seed: int, stream: str) -> int:
    return int(rng(seed, stream).integers(0, 1 << 62))


# -------------------------------------------------------------- inputs ----

_TILES = None


def tiles():
    """The 84 frozen 128x128 photo tiles (uint8 BGR) and their masks
    (labels 0-2)."""
    global _TILES
    if _TILES is None:
        with np.load(os.path.join(HERE, "data", "tiles.npz")) as z:
            _TILES = (z["images_bgr"], z["masks"])
    return _TILES


def mosaics(r: np.random.Generator, n: int, size, device):
    """``n`` images (n, H, W, 3) float32 BGR 0-255 and their labels
    (n, H, W) int64 on ``device``, each a mosaic of the photo tiles at their
    native 128x128 resolution (cropped at the right and bottom edges), every
    tile picked and flipped by the seed.  Native tiles keep the photos'
    detail: upsampled tiles are so smooth that a depthwise kernel whose taps
    nearly cancel leaves only rounding noise in its channel."""
    import torch
    X, Y = tiles()
    t = X.shape[1]
    H, W = size
    gy, gx = -(-H // t), -(-W // t)
    idx = r.integers(0, 2 * len(X), size=(n, gy, gx))
    pick, flip = idx // 2, (idx % 2).astype(bool)
    img = X[pick]                                     # (n, gy, gx, t, t, 3)
    lab = Y[pick]
    img = np.where(flip[..., None, None, None], img[:, :, :, :, ::-1], img)
    lab = np.where(flip[..., None, None], lab[:, :, :, :, ::-1], lab)
    img = img.transpose(0, 1, 3, 2, 4, 5).reshape(n, gy * t, gx * t, 3)
    lab = lab.transpose(0, 1, 3, 2, 4).reshape(n, gy * t, gx * t)
    img = torch.from_numpy(np.ascontiguousarray(img[:, :H, :W]))
    lab = torch.from_numpy(np.ascontiguousarray(lab[:, :H, :W]))
    return img.to(device).float(), lab.to(device).long()


def images(r: np.random.Generator, n: int, size, device):
    """The images of :func:`mosaics`."""
    return mosaics(r, n, size, device)[0]


# ------------------------------------------------------------- weights ----

def make_weights(cfg: dict, seed: int, device, calib: int = 8, size=None):
    """Seeded weights for ``cfg`` on ``device``: one normal draw on the
    device, He-scaled kernels (the head at 1/fan_in), BN gamma 1 + 0.1 n,
    beta 1 + 0.1 n, the head's bias 0.1 n; then every BN's moving
    statistics from one seeded batch of ``calib`` photo variants through
    the plain reference (its batch statistics).  The shift of 1 keeps most
    ReLUs open: at beta 0 a random net of this depth is so chaotic that
    bf16 rounding alone changes a tenth of its argmax labels (PERF.md)."""
    import torch
    from portbench.reference import model as R
    specs = R.layer_specs(cfg)
    total = sum(math.prod(s) for _, s, _ in specs)
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    w, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind in ("conv", "dw"):
            fan_in = shape[1] * shape[2] * shape[3]
            gain = 1.0 if name.startswith("conv_upsample") else 2.0
            t = t * math.sqrt(gain / fan_in)
        elif kind == "gamma":
            t = 1.0 + 0.1 * t
        elif kind == "beta":
            t = 1.0 + 0.1 * t
        elif kind == "bias":
            t = 0.1 * t
        elif kind == "mean":
            t = torch.zeros(shape, device=device)
        elif kind == "var":
            t = torch.ones(shape, device=device)
        w[name] = t.contiguous()
    with no_tf32():
        img = images(rng(seed, "calibration"), calib,
                     size or cfg["image_size"], device)
        for name, (mean, var) in R.calibrate(cfg, w, img).items():
            w[name + ".moving_mean"] = mean.clone()
            w[name + ".moving_variance"] = var.clone()
    return w


def load_into(net, w: dict):
    """Copy the harness's weights into the program's net, name by name;
    every parameter and buffer of the net is set."""
    import torch
    sd = net.state_dict()
    missing = sorted(set(sd) - set(w))
    extra = sorted(set(w) - set(sd))
    if missing or extra:
        raise BenchError(f"weight names differ: missing {missing[:5]}, "
                         f"unknown {extra[:5]}")
    with torch.no_grad():
        for k, t in sd.items():
            t.copy_(w[k].to(t.device, t.dtype))


class no_tf32:
    """float32 products without TF32 (the reference's precision)."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _fp8(t, dtype, top):
    import torch
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


def _fp8_classes():
    import torch

    class Operand(torch.autograd.Function):
        """float8 e4m3 in the forward; the gradient passes straight."""

        @staticmethod
        def forward(ctx, t):
            return _fp8(t, torch.float8_e4m3fn, 448.0)

        @staticmethod
        def backward(ctx, g):
            return g

    class Grad(torch.autograd.Function):
        """The identity in the forward; the gradient in float8 e5m2."""

        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return _fp8(g, torch.float8_e5m2, 57344.0)

    return Operand, Grad


class FP8:
    """The control's precision, one step below bf16: every conv operand
    rounded to float8 e4m3 with a per-tensor scale (amax to 448), and in a
    backward every conv's output gradient to float8 e5m2 (amax to 57344),
    the usual float8 training recipe; arithmetic in float32.  With
    ``activations`` (a policy whose activations are bf16) every conv's
    output is stored in e4m3 as well."""

    def __init__(self, activations: bool = False):
        self.operand, self.grad = _fp8_classes()
        self.activations = activations

    def __call__(self, t):
        return self.operand.apply(t)

    def grad_out(self, y):
        if self.activations:
            y = self.operand.apply(y)
        return self.grad.apply(y) if y.requires_grad else y


def control_precision(cell: str):
    """The control's rounding for ``cell``: float8 operands, and float8
    activations where the cell's policy keeps its activations in bf16."""
    _, workload, config = cell_files(benchmark(), cell)
    policy = workload.get("compute_dtype", config["policy"])
    return FP8(activations=policy == "bfloat16")


# -------------------------------------------------------------- timing ----

def sync(device):
    import torch
    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize()


class Tracer:
    """A ``torch.profiler`` window over the block; on exit, the device ops
    with their regions (``portbench/trace.py``), the traced window's
    length and the union of device op intervals."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        sync(self.device)
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from portbench import trace as T
        sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = T.load(path)
        finally:
            os.unlink(path)
        self.ops = T.device_ops(events)
        self.on_device = any(e.get("cat") in T.DEVICE_CATS for e in events)
        self.busy_s = T.busy_us(self.ops) / 1e6 if self.on_device else 0.0
        self.gaps = T.idle_gaps(self.ops, events) if self.on_device else []


# --------------------------------------------------------------- result ----

class Run:
    """What a run hands its per-layer readers: the cell's files, its image
    size, the traffic kind's records and, in a traced run, the trace."""

    def __init__(self, cell, workload, config, size, records, tracer=None):
        self.cell, self.workload, self.config = cell, workload, config
        self.size, self.records = tuple(size), records
        self.trace = tracer


def breakdown(tracer) -> dict:
    """The traced window's ten device ops that took most time (by name)
    and ten longest idle stretches (by what the host launched after
    them), in seconds."""
    by_name = {}
    for name, scope, dur, info in tracer.ops:
        key = f"{name} [{scope}]" if scope else name
        by_name[key] = by_name.get(key, 0.0) + dur / 1e6
    gaps = {}
    for label, sec in tracer.gaps:
        gaps[label] = gaps.get(label, 0.0) + sec
    top = lambda d: [[k[:160], v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def forbidden_modules():
    """Top-level names of loaded modules that the port's runs must not
    load (JAX, its libraries and the JAX package)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation."""
    return float(np.percentile(np.asarray(values, np.float64), q))
