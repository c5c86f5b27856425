"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``deeplab_tpu_torch``).  The run builds the cell's system
from its configuration with seeded weights, warms up every shape its
traffic uses (``setup_s``: from the start of this process to the window),
drives the traffic for ``--seconds``, and then compares what the timed
path produced with the plain reference.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device`` and, traced, ``breakdown``; its last key,
``checks``, and the last lines of standard error give each compared number
beside its limit.

Exits 3 without a result when there is no CUDA card or fewer cards than
the cell asks for, and 4 when a module of JAX or of the JAX package is
loaded once the window has closed.  Build and kernel caches stay inside
the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):            # run as a file: python3 portbench/run.py
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness as H  # noqa: E402

CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
              "TORCHINDUCTOR_CACHE_DIR", "CUDA_CACHE_PATH")


def fixed_caches(root: str):
    """Every kernel and build cache at a fixed path inside the checkout."""
    base = os.path.join(root, "build", "portbench_cache")
    for var in CACHE_VARS:
        os.environ[var] = os.path.join(base, var.lower())


class Context:
    """One run: its arguments, the cell's files and the device."""

    def __init__(self, args, bench, entry, workload, config, device,
                 size=None):
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.bench, self.entry = bench, entry
        self.workload, self.config = workload, config
        self.device = device
        self.size = tuple(size or config["image_size"])
        self.cell = entry["name"]


def require_cards(n: int):
    """The card check: CUDA present and at least ``n`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise H.BenchError("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise H.BenchError(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {n}")


def execute(args, device=None, size=None, overrides=None, root=H.ROOT):
    """Run the cell; returns (result dict, checks).  ``device``, ``size``
    and ``overrides`` (workload parameters) serve the CPU tests."""
    import torch
    bench = H.benchmark(root)
    entry, workload, config = H.cell_files(bench, args.workload, root)
    workload = {**workload, **(overrides or {})}
    if device is None:
        require_cards(entry["chips"])
        device = torch.device("cuda")
    kind = H.load_module("traffic", workload["kind"], root)
    ctx = Context(args, bench, entry, workload, config, device, size)
    st = kind.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    rec = kind.window(ctx, st, args.seconds)
    H.sync(device)
    mem = (torch.cuda.max_memory_allocated() if device.type == "cuda"
           else 0)
    found = H.forbidden_modules()
    if found:
        raise H.BenchError(f"forbidden modules loaded: {found}")
    run = H.Run(ctx.cell, workload, config, ctx.size, rec,
                rec.get("tracer"))
    metrics = {}
    if ctx.trace:
        for m in H.metrics_of(bench, ctx.cell, "per_layer"):
            v = H.load_module("metrics", m["name"], root).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(kind.end_to_end(rec), setup_s=setup_s)
        for m in H.metrics_of(bench, ctx.cell, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    numbers = kind.check(ctx, st, rec)
    from portbench import compare as C
    checks = C.judge(numbers, workload["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name() if device.type == "cuda"
                    else "cpu"),
           "count": entry["chips"] if device.type == "cuda" else 0,
           "memory_peak_bytes": int(mem)}
    tracer = rec.get("tracer")
    if tracer is not None:
        dev["busy_s"] = tracer.busy_s
        dev["window_s"] = tracer.window_s
    result = {"correct": all(c[3] for c in checks),
              "attempted": rec.get("attempted", rec.get("images", 0)),
              "failed": rec.get("failed", 0),
              "metrics": metrics, "device": dev}
    if tracer is not None:
        result["breakdown"] = H.breakdown(tracer)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in checks}
    return result, checks


def emit(result, checks, out=None, err=None):
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, v, lim, ok in checks:
        print(f"check {name}: {v!r} limit {lim!r} "
              f"{'ok' if ok else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches(H.ROOT)
    try:
        result, checks = execute(args)
    except H.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4 if "forbidden" in str(e) else 3
    emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
