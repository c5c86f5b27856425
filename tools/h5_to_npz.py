#!/usr/bin/env python3
"""Convert a Keras h5 weight file into the port's numpy-only ``.npz``.

    python tools/h5_to_npz.py tests/data/mini_voc_trained.h5 \
        tests/data/mini_voc_trained.npz --classes 3

The h5 is loaded by layer name into a ``deeplab_tpu_torch`` ``SegNet`` of
the given configuration (``params.load_keras_h5``), then written with
``params.save_npz``: every parameter and BN statistic in the Keras layout
under the serving artifact's keys.  A machine without ``h5py`` (the card's)
reads the result with ``params.load_npz``.  Needs ``h5py``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deeplab_tpu_torch.models.seg_model import SegNet  # noqa: E402
from deeplab_tpu_torch.params import load_keras_h5, save_npz  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("h5")
    p.add_argument("npz")
    p.add_argument("--classes", type=int, default=21)
    p.add_argument("--backbone", default="mobilenetv2",
                   choices=("mobilenetv2", "xception"))
    p.add_argument("--net", default="original",
                   choices=("original", "subpixel"))
    p.add_argument("--OS", type=int, default=16)
    p.add_argument("--alpha", type=float, default=1.0)
    a = p.parse_args(argv)
    # the weights do not depend on the input size
    net = SegNet((64, 64), a.classes, a.backbone, a.net, OS=a.OS,
                 alpha=a.alpha)
    save_npz(a.npz, load_keras_h5(a.h5, net))
    print(f"{a.h5} -> {a.npz} ({os.path.getsize(a.npz) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
