"""Readings that the limits of ``correct`` are set from, in one process.

    python3 -m portbench.control --workload <cell> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...] [--fault half_batch]

For each ``--seeds`` seed: the cell's set-up and a short window of its
traffic at the cell's own sizes, then the same comparison a run makes
(the program's reading).  For each ``--control-seeds`` seed: the same
set-up and window, then the comparison with the plain reference computed
one precision step below the configuration's (float8 e4m3 operands for
the "mixed" and bf16 policies) in the program's place; with ``--fault``,
the reference with that fault planted instead.  One JSON line a reading
on standard output.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness as H
from portbench import run as RUN


def readings(cell, seconds, seeds, control=None, device=None, size=None,
             overrides=None):
    """[(seed, numbers)] of the program (``control=None``) or of the
    control in its place."""
    import torch
    bench = H.benchmark()
    entry, workload, config = H.cell_files(bench, cell)
    workload = {**workload, **(overrides or {})}
    if device is None:
        RUN.require_cards(entry["chips"])
        device = torch.device("cuda")
    kind = H.load_module("traffic", workload["kind"])
    out = []
    for seed in seeds:
        args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
        ctx = RUN.Context(args, bench, entry, workload, config, device, size)
        st = kind.setup(ctx)
        rec = kind.window(ctx, st, seconds)
        out.append((seed, kind.check(ctx, st, rec, control)))
        del st, rec
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                   help="workload parameters to override (diagnostics)")
    args = p.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in
                 (kv.split("=", 1) for kv in args.set)}
    RUN.fixed_caches(H.ROOT)
    t0 = time.perf_counter()
    for which, seeds, control in (
            ("program", args.seeds, None),
            ("control", args.control_seeds,
             {"fault": args.fault} if args.fault
             else {"quant": H.control_precision(args.workload)})):
        if not seeds:
            continue
        for seed, numbers in readings(args.workload, args.seconds, seeds,
                                      control, overrides=overrides):
            print(json.dumps({"cell": args.workload, "which": which,
                              "fault": args.fault if control else None,
                              "seed": seed, "numbers": numbers,
                              "t": round(time.perf_counter() - t0, 1)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
