"""Itemize the bf16 train step into per-region device-time buckets (the
port's counterpart of the JAX repo's ``tools/profile_train.py``).

The program is the port's bf16 train step of ``SegNet(512x512, 21,
"mobilenetv2", "original")`` at B=16: ``Trainer(compute_dtype=bfloat16,
profile_dir=...)`` fits one epoch of seeded batches and traces steps
``[2, 5)``, 3 steps.  The trace is read by ``tools/trace.py``: each kernel
lands in the region of the labels the models and the Trainer emit
(``models/mobilenetv2.py``: ``stem`` / ``mbNNsS``, ``deeplabv3p.py``:
``aspp``, ``train/trainer.py``: ``loss`` / ``optimizer`` /
``step_metrics``), the backward in its forward op's region.

    python -m deeplab_tpu_torch.tools.profile_train [--bs 16] [--size 512]
        [--logdir DIR] [--device cpu]       # trace and itemize
    python -m deeplab_tpu_torch.tools.profile_train --trace DIR [--bs 16]
                                            # itemize a trace already taken

Prints the region table, the fwd / bwd / unscoped split, the top ops of
``other``, ``mb_blocks`` and ``optimizer``, and a one-line JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from deeplab_tpu_torch.tools import trace as T

SZ = (512, 512)
STEPS = (2, 5)            # the traced window: 3 steps after 2 of warm-up

# stride-2 blocks from models/mobilenetv2.BLOCK_TABLE (ids 1 and 3)
_STRIDE2 = ("mb01s2", "mb03s2")

# ordered first-match-wins region rules over the scope string
RULES = [
    ("stem", lambda s: "stem" in s),
    ("stride2_blocks", lambda s: any(t in s for t in _STRIDE2)),
    ("mb_blocks", lambda s: re.search(r"mb\d{2}s\d", s) is not None),
    ("aspp", lambda s: "aspp" in s),
    ("head", lambda s: "head" in s),
    ("loss", lambda s: "loss" in s),
    ("optimizer", lambda s: "optimizer" in s),
    ("step_metrics", lambda s: "step_metrics" in s),
]


def program(logdir: str, bs: int = 16, size=SZ, n_classes: int = 21,
            device=None, compute_dtype=None, net=None):
    """(trainer, net, batches): the traced program, ready to ``fit`` — a
    ``Trainer`` that traces ``STEPS`` into ``logdir``, and one epoch of
    seeded batches of ``bs``.  bf16 unless ``compute_dtype`` is given; the
    net is a seeded ``SegNet`` unless ``net`` is given (``Deeplabv3`` also
    labels its ``head``)."""
    import numpy as np
    import torch

    from deeplab_tpu_torch.data.generator import ArrayBatcher
    from deeplab_tpu_torch.models.seg_model import SegNet
    from deeplab_tpu_torch.train.trainer import Trainer

    rng = np.random.RandomState(0)
    n = bs * STEPS[1]
    X = (rng.rand(n, size[0], size[1], 3) * 255).astype(np.float32)
    Y = rng.randint(0, n_classes, (n, size[0] * size[1], 1))
    if net is None:
        net = SegNet(tuple(size), n_classes, "mobilenetv2", "original")
    tr = Trainer(net, epochs=1, verbose=0, device=device, workers=0,
                 compute_dtype=compute_dtype or torch.bfloat16,
                 profile_dir=logdir, profile_steps=STEPS)
    return tr, net, ArrayBatcher(X, Y, bs, n_classes=n_classes)


def run(logdir: str, *args, **kw):
    """Fit :func:`program`'s epoch, tracing ``STEPS``; returns the trace's
    path."""
    tr, net, batches = program(logdir, *args, **kw)
    tr.fit(net, batches)
    return tr.profiler.path


def itemize(path: str, bs: int = 16, top: int = 8, quiet: bool = False):
    """The region table of the trace at ``path`` (a file or a directory,
    its newest trace), per step.  Returns the JSON record, with the table's
    parts under ``_ops`` (the attributed ops), ``_tops``, ``_regions``
    (unrounded), ``split_ms`` and ``busy_ms`` (the union of the device ops' intervals, per step)."""
    if os.path.isdir(path):
        path = T.newest_trace(path)
    steps = STEPS[1] - STEPS[0]
    ops = T.device_ops(T.load(path))
    totals, members = T.bucket(ops, RULES)
    per_step = {k: v / steps for k, v in totals.items()}
    tot = sum(per_step.values())
    fwd, bwd, none = (v / 1e3 / steps for v in T.split(ops))
    matched = 1.0 - per_step.get("other", 0.0) / max(tot, 1e-9)
    rec = {"metric": "train_step_region_ms", "bs": bs,
           "regions": {k: round(v, 3) for k, v in sorted(
               per_step.items(), key=lambda kv: -kv[1])},
           "total_ms": round(tot, 3),
           "device_img_s": round(bs / (tot / 1e3), 2) if tot else 0.0,
           "split_ms": {"fwd": fwd, "bwd": bwd, "unscoped": none},
           "unscoped_share": none / max(tot, 1e-9),
           "busy_ms": T.busy_us(ops) / 1e3 / steps}
    if not quiet:
        print(f"train step bs={bs} — device time per step ({steps} steps "
              f"traced; {matched:.0%} of time in a region)")
        T.print_table(per_step, total_label="TOTAL")
        print(f"  fwd-scoped {fwd:8.3f} ms   bwd-scoped {bwd:8.3f} ms   "
              f"unscoped {none:8.3f} ms ({100 * rec['unscoped_share']:.1f}%)")
        print(f"  => {rec['device_img_s']:.1f} img/s of pure device op time")
        for region in ("other", "mb_blocks", "optimizer"):
            print(f"\ntop ops in '{region}':")
            for k, v in members.get(region, [])[:top]:
                print(f"  {v / steps:8.3f} ms  {k[:110]}")
        print(json.dumps({k: v for k, v in rec.items()
                          if k in ("metric", "bs", "regions", "total_ms",
                                   "device_img_s")}))
    rec["_ops"], rec["_tops"], rec["_regions"] = ops, members, per_step
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", help="itemize this trace (file or directory)")
    ap.add_argument("--logdir", default="prof/train")
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--size", type=int, default=SZ[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    path = args.trace or run(args.logdir, args.bs, (args.size, args.size),
                             device=args.device)
    itemize(path, args.bs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
