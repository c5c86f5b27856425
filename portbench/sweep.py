"""Offered-rate sweep of an open-loop serving cell, to find its knee once.

    python3 -m portbench.sweep --workload <cell> --seed <n> --seconds <s>
        --rates <r> ...

One set-up, then for each rate the cell's arrivals at that rate for
``--seconds``: p50, p95 and p99 latency, the completed rate, and the
backlog's growth (the median latency of the last third of the requests
over that of the first third).  One JSON line a rate.  The benchmark's
own runs do not run this; a cell's rate is written into its workload
file as a number.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from portbench import harness as H
from portbench import run as RUN


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    RUN.fixed_caches(H.ROOT)
    bench = H.benchmark()
    entry, workload, config = H.cell_files(bench, args.workload)
    RUN.require_cards(entry["chips"])
    kind = H.load_module("traffic", workload["kind"])
    ns = argparse.Namespace(seed=args.seed, seconds=args.seconds, trace=0)
    ctx = RUN.Context(ns, bench, entry, workload, config,
                      torch.device("cuda"))
    st = kind.setup(ctx)
    for rate in args.rates:
        n_calls = len(st["timed"].calls)
        lat, done, failed, _, late = kind.drive(
            st, args.seed, rate, args.seconds, workload["clients"], set())
        ok = np.isfinite(lat)
        third = max(1, len(lat) // 3)
        first, last = np.median(lat[:third]), np.median(lat[-third:])
        span = np.nanmax(done[np.isfinite(done)]) - (
            np.nanmin(done[np.isfinite(done)]) - np.nanmin(lat[ok]))
        calls = len(st["timed"].calls) - n_calls
        print(json.dumps({
            "rate": rate, "requests": len(lat), "failed": len(failed),
            "p50_ms": 1e3 * H.percentile(lat[ok], 50),
            "p95_ms": 1e3 * H.percentile(lat[ok], 95),
            "p99_ms": 1e3 * H.percentile(lat[ok], 99),
            "completed_per_s": float(ok.sum() / span),
            "backlog_growth": float(last / first),
            "batch_mean": float(ok.sum() / max(calls, 1)),
            "late_ms": 1e3 * late}), flush=True)
    st["server"].dispatcher.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
