"""Cityscapes dataset adapter (deeplab_tpu/data/cityscapes.py).

Layout: ``leftImg8bit/{split}/{city}/*_leftImg8bit.png`` images with
``gtFine/{split}/{city}/*_gtFine_labelIds.png`` labels.  Raw labelIds map to
the 19 official train ids; ignored classes become void.  The adapter keeps
the ``SegmentationGenerator``'s augmentation and weighting and replaces its
path discovery and label reading.  (One host: the JAX adapter's per-host
shard comes with the multi-GPU slice.)
"""

from __future__ import annotations

import glob
import os

import numpy as np

from deeplab_tpu_torch.data.generator import (SegmentationGenerator,
                                              _resolve_host_shard,
                                              _imread_bgr, _imread_gray,
                                              reference_split)

# official trainId mapping: labelId -> trainId (255 = ignore)
_ID_TO_TRAIN = np.full(256, 255, np.uint8)
for _lid, _tid in [(7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5),
                   (19, 6), (20, 7), (21, 8), (22, 9), (23, 10), (24, 11),
                   (25, 12), (26, 13), (27, 14), (28, 15), (31, 16),
                   (32, 17), (33, 18)]:
    _ID_TO_TRAIN[_lid] = _tid

N_CLASSES = 19

CLASS_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic_light", "traffic_sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]


class CityscapesGenerator(SegmentationGenerator):
    """``SegmentationGenerator`` over the Cityscapes layout with trainId
    labels.  ``mode`` 'train' | 'validation' | 'test' reads the dataset's
    own train / val / test split, unless ``validation_split`` > 0: then the
    reference's seeded split of the train set (the VOC workflow's).
    ``host_id``/``num_hosts``: the per-host shard, as the parent's."""

    def __init__(self, folder, mode="train", n_classes=N_CLASSES,
                 validation_split=0.0, seed=7, host_id=None,
                 num_hosts=None, **kw):
        split_dir = "train" if (mode in ("train", "validation")
                                and validation_split > 0) else \
            {"train": "train", "validation": "val", "test": "test"}[mode]
        images = sorted(glob.glob(os.path.join(
            folder, "leftImg8bit", split_dir, "*", "*_leftImg8bit.png")))
        labels = [p.replace(f"{os.sep}leftImg8bit{os.sep}",
                            f"{os.sep}gtFine{os.sep}")
                  .replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                  for p in images]
        # the parent's VOC discovery over a folder that does not exist, then
        # this layout's lists (and the optional seeded subsplit)
        super().__init__(folder=os.path.join(folder, "__none__"), mode=mode,
                         n_classes=n_classes,
                         validation_split=validation_split, seed=seed, **kw)
        if validation_split > 0 and mode in ("train", "validation"):
            idx = reference_split(len(images), validation_split, seed, mode)
            images = [images[j] for j in idx]
            labels = [labels[j] for j in idx]
        host_id, num_hosts = _resolve_host_shard(host_id, num_hosts)
        if num_hosts > 1:
            images = images[host_id::num_hosts]
            labels = labels[host_id::num_hosts]
        self.image_path_list = images
        self.label_path_list = labels

    def _load_pair(self, image_path, label_path):
        # 255 (ignore) exceeds n_classes - 1: the parent's label hygiene
        # makes it void
        return _imread_bgr(image_path), _ID_TO_TRAIN[_imread_gray(label_path)]
