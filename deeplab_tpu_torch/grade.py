"""Grade the production serving pipeline in the baseline's own mIoU units
(the port's counterpart of the JAX repo's ``tools/grade_production.py``).

The quality criterion is "mIoU within 0.1 pt" of the parity pipeline.  Per-
stage agreements do not compose into an mIoU bound, so this module measures
the composition: it runs both stacks

  parity:      float32 (TF32 off), the reference-faithful CRF
               ``CrfConfig()`` (color_step 1, gaussian taps, splat_stride 1:
               the pydensecrf parameter mirror)
  production:  the serving defaults, the "mixed" model policy (f32
               activations, bf16 conv operands, f32 accumulation; the fused
               kernels on the card) and ``crf.PRODUCTION_CONFIG``

over committed real-photo tiles with the committed trained weights
(``tests/data/mini_voc_trained.npz``, 3 classes, readable without
``h5py``), scores each with the published metric (the notebook's
confusion-matrix mean with its ``conf_m[l-1, p-1]`` shift) and with standard
mean IoU, and reports the delta in percentage points with a bootstrap 95%
CI over images.

Two tile sets:

  split="select"  tests/data/mini_voc, 20 tiles: the set the CRF configs
                  were chosen on; use it only to choose configs.
  split="eval"    tests/data/mini_voc_eval, 64 held-out tiles at disjoint
                  positions: the grading set.

On the card: ``python -m deeplab_tpu_torch.grade [select|eval]`` prints the
record and the shortfall line.  Anywhere else pass ``device="cpu"``
(``grade(..., device="cpu")``); without a card and without it, ``grade``
raises.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_SELECT = os.path.join(REPO, "tests", "data", "mini_voc")
DATA_EVAL = os.path.join(REPO, "tests", "data", "mini_voc_eval")
WEIGHTS = os.path.join(REPO, "tests", "data", "mini_voc_trained.npz")
N_CLASSES = 3
# the criterion: production may score at most this many points below parity
CRITERION_PT = 0.1


def _load_tiles(size, data=DATA_SELECT):
    """All committed tiles under ``data`` as (images BGR f32, labels int32)
    at ``size`` (images bilinear, labels nearest: the generator's resize
    semantics)."""
    from deeplab_tpu_torch.data.augment import resize_bilinear, resize_nearest
    from deeplab_tpu_torch.data.generator import _imread_bgr, _imread_gray

    img_dir = os.path.join(data, "JPEGImages", "train")
    lbl_dir = os.path.join(data, "SegmentationClassAug")
    X, Y = [], []
    for n in sorted(os.listdir(img_dir)):
        im = _imread_bgr(os.path.join(img_dir, n))
        lb = _imread_gray(os.path.join(lbl_dir, n.replace(".jpg", ".png")))
        if (im.shape[0], im.shape[1]) != tuple(size):
            im = resize_bilinear(im, (size[1], size[0]))
            lb = resize_nearest(lb, (size[1], size[0]))
        X.append(im.astype(np.float32))
        Y.append(lb.astype(np.int32))
    return np.stack(X), np.stack(Y)


def _per_image_conf(labels, preds, n_classes):
    """(N, n, n) int64 per-image confusion matrices (void excluded)."""
    out = np.zeros((len(labels), n_classes, n_classes), np.int64)
    for i, (l, p) in enumerate(zip(labels, preds)):
        l = l.reshape(-1)
        p = p.reshape(-1)
        keep = l < n_classes
        idx = l[keep] * n_classes + p[keep]
        out[i] = np.bincount(idx, minlength=n_classes * n_classes).reshape(
            n_classes, n_classes)
    return out


def _published(conf):
    """The notebook's metric from a summed confusion matrix: roll by
    (-1, -1) (the conf_m[l-1, p-1] quirk), row-normalize, mean of the
    diagonal.  The numpy twin of ``metrics.mean_iou_published``."""
    c = np.roll(conf, (-1, -1), axis=(0, 1)).astype(np.float64)
    row = c / np.maximum(c.sum(axis=1, keepdims=True), 1.0)
    return float(np.mean(np.diagonal(row)))


def _std_miou(conf):
    c = conf.astype(np.float64)
    diag = np.diagonal(c)
    denom = c.sum(axis=1) + c.sum(axis=0) - diag
    return float(np.nanmean(diag / np.maximum(denom, 1.0)))


def _bootstrap_ci(conf_par, conf_pro, n_boot=2000, seed=0):
    """95% CI of (published_production - published_parity) in points,
    resampling images (both stacks see the same resample, so the delta's
    correlation across images is kept)."""
    rng = np.random.RandomState(seed)
    n = len(conf_par)
    deltas = np.empty(n_boot)
    for b in range(n_boot):
        idx = rng.randint(0, n, n)
        deltas[b] = (_published(conf_pro[idx].sum(0))
                     - _published(conf_par[idx].sum(0))) * 100.0
    lo, hi = np.percentile(deltas, [2.5, 97.5])
    return round(float(lo), 3), round(float(hi), 3)


def _net(size, weights=WEIGHTS):
    """The graded net: MobileNetV2 with the 'original' head, ``N_CLASSES``
    classes, the weights loaded strictly (every layer and variable)."""
    from deeplab_tpu_torch.models.seg_model import SegNet
    from deeplab_tpu_torch.params import load_npz
    return load_npz(weights, SegNet(size, N_CLASSES, "mobilenetv2",
                                    "original"), strict=True)


def _stacks(net, production_crf=None, production_dtype="mixed", device=None):
    """{"parity": Predictor, "production": Predictor} over ``net`` on
    ``device`` (the card unless ``"cpu"``; no card raises)."""
    from deeplab_tpu_torch.crf import PRODUCTION_CONFIG, CrfConfig
    from deeplab_tpu_torch.predictor import Predictor
    crf_pro = PRODUCTION_CONFIG if production_crf is None else production_crf
    return {"parity": Predictor(net, crf=CrfConfig(),
                                compute_dtype="float32", device=device),
            "production": Predictor(net, crf=crf_pro,
                                    compute_dtype=production_dtype,
                                    device=device)}


def _launch_counts():
    """Each serving kernel's launch count ({name: n}); a wrapper counts
    only where it launches its kernel, never on the CPU."""
    from deeplab_tpu_torch.kernels import crf_fused as CK
    from deeplab_tpu_torch.kernels import fused_dw as FDW
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    out = {"fused_mbconv": FM.fused_mbconv.launches,
           "fused_dw_bn_relu6": FDW.fused_dw_bn_relu6.launches}
    out.update({n: getattr(CK, n).launches
                for n in CK.KERNELS + CK.BLUR_PASSES})
    return out


def _serve(pred, X, batch):
    """``pred`` over ``X`` in batches of ``batch``: (masks (N, H, W) int32,
    [{kernel: launches} of each batch, launched kernels only])."""
    masks, launches = [], []
    for i in range(0, len(X), batch):
        before = _launch_counts()
        masks.append(pred(X[i:i + batch]))
        after = _launch_counts()
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    return np.concatenate(masks), launches


def grade_runs(size=(512, 512), batch=8, weights=WEIGHTS, split="eval",
               production_crf=None, production_dtype="mixed", device=None):
    """:func:`grade`, and what each stack gave: ``(record, {stack: {"masks":
    (N, H, W) int32, "launches": [{kernel: launches} of each batch]}})``."""
    from deeplab_tpu_torch.core import resolve_device
    device = resolve_device(device)     # no card and no "cpu" raises here
    data = DATA_EVAL if split == "eval" else DATA_SELECT
    stacks = _stacks(_net(size, weights), production_crf, production_dtype,
                     device)
    X, Y = _load_tiles(size, data)
    runs, confs = {}, {}
    for name, pred in stacks.items():
        masks, launches = _serve(pred, X, batch)
        runs[name] = {"masks": masks, "launches": launches}
        confs[name] = _per_image_conf(Y, masks, N_CLASSES)

    conf_par, conf_pro = confs["parity"], confs["production"]
    pub_par, pub_pro = _published(conf_par.sum(0)), _published(conf_pro.sum(0))
    std_par, std_pro = _std_miou(conf_par.sum(0)), _std_miou(conf_pro.sum(0))
    lo, hi = _bootstrap_ci(conf_par, conf_pro)
    crf_pro = stacks["production"].crf
    record = {
        "miou_published_parity": round(pub_par, 4),
        "miou_published_production": round(pub_pro, 4),
        "delta_published_pt": round((pub_pro - pub_par) * 100.0, 3),
        "ci95_delta_published_pt": [lo, hi],
        "miou_std_parity": round(std_par, 4),
        "miou_std_production": round(std_pro, 4),
        "delta_std_pt": round((std_pro - std_par) * 100.0, 3),
        "images": int(len(X)),
        "split": split,
        "size": f"{size[0]}x{size[1]}",
        "production_policy": ("mixed+" + _crf_tag(crf_pro)
                              if production_dtype == "mixed"
                              else str(production_dtype)),
        # every stack launched the port's CUDA kernels (never on the CPU)
        "fused_kernels_available": all(
            any(b for b in r["launches"]) for r in runs.values()),
    }
    return record, runs


def grade(size=(512, 512), batch=8, weights=WEIGHTS, split="eval",
          production_crf=None, production_dtype="mixed", device=None):
    """Run both stacks over the ``split`` tiles; returns the record dict.

    ``production_crf``/``production_dtype`` override the production stack:
    for config-selection experiments on split="select" only (grading a
    config on the tiles it was chosen on is the bias the eval split
    removes).  ``device``: the card unless ``"cpu"``."""
    return grade_runs(size, batch, weights, split, production_crf,
                      production_dtype, device)[0]


def shortfall(record) -> float:
    """Points by which production scores below parity on either metric (0
    where it scores at least as well)."""
    return max(-record["delta_published_pt"], -record["delta_std_pt"], 0.0)


def _crf_tag(cfg):
    tag = f"cs{cfg.color_step:g}{cfg.color_taps}"
    if cfg.splat_stride > 1:
        tag += f"st{cfg.splat_stride}"
    return tag


if __name__ == "__main__":
    split = sys.argv[1] if len(sys.argv) > 1 else "eval"
    rec = grade(split=split)
    print(json.dumps(rec))
    # the criterion is a quality floor: production may not score more than
    # 0.1 pt below parity (a positive delta is production >= parity)
    short = shortfall(rec)
    print(f"production-vs-parity mIoU shortfall: {short:.3f} pt "
          f"({'MEETS' if short <= CRITERION_PT else 'MISSES'} the 0.1 pt "
          f"criterion)")
