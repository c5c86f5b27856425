"""Itemize the Xception serving forward into per-region device-time buckets
(the port's counterpart of the JAX repo's ``tools/profile_xception.py``).

The program is the serving stage ``SegNet(512x512, 21, "xception")``
``predict_ids`` under "mixed" followed by the CRF (``mean_field_batched``
at ``CrfConfig()``) at B=16, 3 calls traced with ``profiling.trace``.  The
regions are the labels ``models/xception.py`` emits (``xstem``,
``xentry1``-``3``, ``xmidNN``, ``xexit1``-``2``) and ``deeplabv3p.py``'s
``aspp``; the decoder, the head and the CRF carry no label and land in
``crf+other``, as on the TPU.

    python -m deeplab_tpu_torch.tools.profile_xception [--bs 16]
        [--size 512] [--logdir DIR] [--device cpu]
    python -m deeplab_tpu_torch.tools.profile_xception --trace DIR

Prints the region table, the top ops of each region and a one-line JSON
record.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from deeplab_tpu_torch.tools import trace as T

SZ = (512, 512)
CALLS = 3

# ordered first-match-wins region rules over the scope string
RULES = [
    ("xstem", lambda s: "xstem" in s),
    ("xentry1", lambda s: "xentry1" in s),
    ("xentry2", lambda s: "xentry2" in s),
    ("xentry3", lambda s: "xentry3" in s),
    ("xmiddle(16)", lambda s: re.search(r"xmid\d{2}", s) is not None),
    ("xexit", lambda s: "xexit" in s),
    ("aspp", lambda s: "aspp" in s),
    ("head", lambda s: "head" in s),
]
DEFAULT = "crf+other"     # the CRF kernels carry no model label


def stage(bs: int = 16, size=SZ, n_classes: int = 21, device=None):
    """One call of the serving stage on seeded images (output stride
    16)."""
    import torch

    from deeplab_tpu_torch import core
    from deeplab_tpu_torch.crf import CrfConfig, mean_field_batched
    from deeplab_tpu_torch.models.seg_model import SegNet

    dev = core.resolve_device(device)
    net = SegNet(tuple(size), n_classes, "xception", "original").to(
        dev).eval()
    gen = torch.Generator().manual_seed(0)
    img = (torch.rand((bs, size[0], size[1], 3), generator=gen) * 255).to(dev)
    cfg = CrfConfig()

    def call():
        ids = net.predict_ids(img, "mixed")
        return mean_field_batched(img, ids, cfg, n_classes)
    return call


def run(logdir: str, bs: int = 16, size=SZ, device=None):
    """Warm the stage up, then trace ``CALLS`` calls into ``logdir``;
    returns the trace's path."""
    from deeplab_tpu_torch.train import profiling
    call = stage(bs, size, device=device)
    call()
    with profiling.trace(logdir):
        for _ in range(CALLS):
            call()
    return T.newest_trace(logdir)


def itemize(path: str, bs: int = 16, top: int = 10, quiet: bool = False):
    """The region table of the trace at ``path`` per call; returns the
    JSON record (with ``_ops``, ``_tops``, ``_regions`` unrounded,
    ``busy_ms``, ``unscoped_share`` beside it)."""
    if os.path.isdir(path):
        path = T.newest_trace(path)
    calls = CALLS
    ops = T.device_ops(T.load(path))
    totals, members = T.bucket(ops, RULES, default=DEFAULT)
    per_call = {k: v / calls for k, v in totals.items()}
    tot = sum(per_call.values())
    none = T.split(ops)[2] / 1e3 / calls
    rec = {"metric": "xception_serving_region_ms", "bs": bs,
           "regions": {k: round(v, 3) for k, v in sorted(
               per_call.items(), key=lambda kv: -kv[1])},
           "total_ms": round(tot, 3),
           "device_img_s": round(bs / (tot / 1e3), 2) if tot else 0.0,
           "unscoped_share": none / max(tot, 1e-9),
           "busy_ms": T.busy_us(ops) / 1e3 / calls}
    if not quiet:
        print(f"xception serving bs={bs} mixed model+CRF — device time per "
              f"call ({calls} calls traced)")
        T.print_table(per_call, total_label="TOTAL")
        print(f"  unscoped {none:8.3f} ms "
              f"({100 * rec['unscoped_share']:.1f}%)")
        print(f"  => {rec['device_img_s']:.1f} img/s of pure device op time")
        for region in [r for r, _ in RULES] + [DEFAULT]:
            if region not in members:
                continue
            print(f"\ntop ops in '{region}':")
            n = 25 if region == DEFAULT else top
            for k, v in members[region][:n]:
                print(f"  {v / calls:8.3f} ms  {k[:110]}")
        print(json.dumps({k: v for k, v in rec.items()
                          if k in ("metric", "bs", "regions", "total_ms",
                                   "device_img_s")}))
    rec["_ops"], rec["_tops"], rec["_regions"] = ops, members, per_call
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", help="itemize this trace (file or directory)")
    ap.add_argument("--logdir", default="prof/xception")
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
