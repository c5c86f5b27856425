"""Render the example gallery from the production stack (the port's
counterpart of the JAX repo's ``tools/make_gallery.py``).

For each of four committed real-photo tiles (``tests/data/mini_voc``,
``PICKS``: indices into the sorted tile list, the JAX gallery's) with the
committed 3-class trained weights (``tests/data/mini_voc_trained.npz``),
it renders

    image | ground truth | prediction | prediction + CRF

with the production serving defaults: ``Predictor`` under "mixed", the
CRF at ``crf.PRODUCTION_CONFIG`` (the stack ``grade.py`` grades).  The
masks always go to ``{out_dir}/gallery_masks.npz`` (``picks``, ``gt``,
``raw``, ``crf``); the figures to ``{out_dir}/gallery_exp{1-4}.png`` where
matplotlib imports.

    python -m deeplab_tpu_torch.tools.make_gallery --out-dir DIR
        [--size 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# four tiles with distinct subjects (the JAX gallery's picks)
PICKS = (0, 5, 10, 17)


def render(out_dir: str, size=(512, 512), device=None) -> dict:
    """Serve the picked tiles through the raw and the production stack and
    write their masks (and figures) into ``out_dir``; returns {"picks",
    "gt", "raw", "crf", "paths"}."""
    from deeplab_tpu_torch import grade as G
    from deeplab_tpu_torch.crf import PRODUCTION_CONFIG
    from deeplab_tpu_torch.predictor import Predictor

    net = G._net(tuple(size))
    X, Y = G._load_tiles(tuple(size))
    raw = Predictor(net, crf=None, compute_dtype="mixed", device=device)
    crf = Predictor(net, crf=PRODUCTION_CONFIG, compute_dtype="mixed",
                    device=device)
    batch = X[list(PICKS)]
    out = {"picks": np.asarray(PICKS), "gt": Y[list(PICKS)],
           "raw": raw(batch), "crf": crf(batch)}
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, "gallery_masks.npz")]
    np.savez(paths[0], **out)
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print("note: no figures (matplotlib does not import):", e)
    else:
        from deeplab_tpu_torch.viz import plot_predictions
        for n, idx in enumerate(PICKS, start=1):
            path = os.path.join(out_dir, f"gallery_exp{n}.png")
            plot_predictions(X[idx], [("ground truth", Y[idx]),
                                      ("prediction", out["raw"][n - 1]),
                                      ("prediction + CRF",
                                       out["crf"][n - 1])], path=path)
            paths.append(path)
    for p in paths:
        print("wrote", p)
    out["paths"] = paths
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    render(args.out_dir, (args.size, args.size), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
