"""Command-line interface (deeplab_tpu/cli.py): the JAX CLI's six
subcommands with their flags, each with ``--device`` (``cuda`` unless the
caller asks for ``cpu``).

    python -m deeplab_tpu_torch.cli export-config > config.json
    python -m deeplab_tpu_torch.cli evaluate --config config.json \
        --weights w.h5
    python -m deeplab_tpu_torch.cli predict --config config.json \
        --weights w.h5 --images img1.jpg img2.jpg --crf --out-dir preds/
    python -m deeplab_tpu_torch.cli export-serving --config config.json \
        --weights w.h5 --crf --out serving.npz
    python -m deeplab_tpu_torch.cli predict --artifact serving.npz \
        --images img1.jpg
    python -m deeplab_tpu_torch.cli serve --artifact serving.npz --port 8517

    python -m deeplab_tpu_torch.cli train --config config.json [--resume]

Weights are a Keras h5 or the port's numpy-only ``.npz`` (``--weights``,
read by ``params.load_weights`` by suffix); without one the net keeps its
seeded initialization, with a warning where it would be served or
exported.  The config's checkpoint, ``{checkpoint_dir}/{backbone}_{net}``,
is ``.h5`` where ``h5py`` imports and ``.npz`` where it does not: ``train``
writes its best weights there, and ``--resume-weights`` and the other
commands read whichever of the two exists.  ``train`` runs in float32, as
the JAX CLI does; ``--resume`` continues from ``train.state_checkpoint``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_PRECISION = {"mixed": "mixed", "bf16": "bfloat16", "f32": "float32"}


def _config(args):
    from deeplab_tpu_torch.config import Config
    return Config.load(args.config) if args.config else Config()


def _checkpoint_stem(cfg) -> str:
    return os.path.join(cfg.train.checkpoint_dir,
                        f"{cfg.model.backbone}_{cfg.model.net}")


def _build(cfg, load_weights=False, weights=None):
    """The ``SegModel`` facade and its net at ``cfg``, with ``weights`` (an
    h5 or npz path) or, with ``load_weights``, the config's checkpoint
    where it exists.  ``seg.modelpath`` is the checkpoint this machine
    writes, or the one of the other format that exists."""
    from deeplab_tpu_torch.params import load_weights as load_file
    from deeplab_tpu_torch.params import weights_suffix
    from deeplab_tpu_torch.models.seg_model import SegModel
    seg = SegModel(cfg.data.dataset, tuple(cfg.model.image_size))
    seg.set_batch_size(cfg.train.batch_size)
    seg.set_num_epochs(cfg.train.epochs)
    net = seg.create_seg_model(cfg.model.net, n=cfg.model.n_classes,
                               backbone=cfg.model.backbone,
                               load_weights=False,
                               OS=cfg.model.OS, alpha=cfg.model.alpha)
    stem = _checkpoint_stem(cfg)
    seg.modelpath = stem + weights_suffix()
    other = stem + (".npz" if seg.modelpath.endswith(".h5") else ".h5")
    if not os.path.exists(seg.modelpath) and os.path.exists(other):
        seg.modelpath = other
    if weights:
        load_file(weights, net)
    elif load_weights and os.path.exists(seg.modelpath):
        seg.load_weights(net)
    return seg, net


def _warn_untrained(args, seg, what: str):
    if not args.weights and not os.path.exists(seg.modelpath):
        print(f"warning: no --weights and no checkpoint at {seg.modelpath} "
              f"— {what} freshly-initialized (untrained) weights")


def _precision(args) -> str:
    """--precision {mixed,bf16,f32} (and the --f32 alias) -> the compute
    policy ``Predictor`` and ``save_serving`` take."""
    if getattr(args, "f32", False):
        return "float32"
    return _PRECISION[getattr(args, "precision", "mixed")]


def _crf_config(cfg):
    from deeplab_tpu_torch.crf import CrfConfig
    return CrfConfig(
        sxy_gaussian=cfg.crf.sxy_gaussian,
        compat_gaussian=cfg.crf.compat_gaussian,
        sxy_bilateral=cfg.crf.sxy_bilateral,
        srgb=cfg.crf.srgb,
        compat_bilateral=cfg.crf.compat_bilateral,
        n_iters=cfg.crf.n_iters)


def _tta(args):
    return tuple(args.tta_scales) if args.tta_scales else None


def cmd_train(args):
    from deeplab_tpu_torch.params import weights_suffix
    from deeplab_tpu_torch.train.callbacks import (EarlyStopping,
                                                   ModelCheckpoint,
                                                   ReduceLROnPlateau)
    from deeplab_tpu_torch.train.trainer import Trainer
    cfg = _config(args)
    seg, net = _build(cfg, load_weights=args.resume_weights,
                      weights=args.weights)
    d = cfg.data
    train_gen = seg.create_generators(
        blur=d.blur, crop_shape=d.crop_shape, mode="train",
        n_classes=cfg.model.n_classes, horizontal_flip=d.horizontal_flip,
        vertical_flip=d.vertical_flip, brightness=d.brightness,
        rotation=d.rotation, zoom=d.zoom,
        validation_split=d.validation_split, seed=d.seed,
        do_ahisteq=d.do_ahisteq)
    valid_gen = seg.create_generators(
        blur=0, crop_shape=d.crop_shape, mode="validation",
        n_classes=cfg.model.n_classes, horizontal_flip=False,
        vertical_flip=False, brightness=0.0, rotation=0.0, zoom=0.0,
        validation_split=d.validation_split, seed=d.seed, do_ahisteq=False)

    t = cfg.train
    # the best weights go where this machine can write them
    ckpt_path = _checkpoint_stem(cfg) + weights_suffix()
    callbacks = [
        ModelCheckpoint(ckpt_path, monitor=t.monitor, mode="max", verbose=1),
        ReduceLROnPlateau(monitor=t.monitor, factor=t.reduce_lr_factor,
                          patience=t.reduce_lr_patience, min_lr=t.min_lr),
        EarlyStopping(monitor=t.monitor, patience=t.early_stop_patience),
    ]
    # freeze only when fine-tuning loaded weights (notebook cell 5):
    # freezing a random trunk would train the head against noise
    have_weights = bool(args.weights) or (args.resume_weights
                                          and os.path.exists(seg.modelpath))
    freeze = t.freeze_before if (args.finetune and have_weights) else None
    if args.finetune and not have_weights:
        print("note: no pretrained weights loaded; training full network "
              "(freeze policy skipped)")
    trainer = Trainer(net, epochs=t.epochs, callbacks=callbacks, lr=t.lr,
                      epsilon=t.epsilon, decay=t.decay,
                      freeze_before=freeze, spatial=t.spatial, ddp=t.ddp,
                      seed=t.seed, profile_dir=args.profile_dir,
                      device=args.device)
    if args.resume and not t.state_checkpoint:
        print("warning: --resume given but train.state_checkpoint is not "
              "configured; starting from epoch 0")
    history = trainer.fit(
        net, train_gen, valid_gen, state_checkpoint=t.state_checkpoint,
        resume_from=t.state_checkpoint if args.resume else None)
    print({k: v[-1] for k, v in history.items() if v})
    print(f"weights: {ckpt_path}"
          + ("" if os.path.exists(ckpt_path) else " (not written: no "
             "epoch improved on " + t.monitor + ")"))


def cmd_evaluate(args):
    from deeplab_tpu_torch.data.voc import get_VOC2012_classes
    from deeplab_tpu_torch.predictor import Predictor
    from deeplab_tpu_torch.viz import calculate_iou
    cfg = _config(args)
    seg, net = _build(cfg, weights=args.weights)
    seg.set_batch_size(1)
    # default to the training split fraction so evaluation never overlaps
    # the train set (the reference notebook's cell 10 hardcodes 0.05:
    # --eval-split 0.05 reproduces its published numbers)
    split = (args.eval_split if args.eval_split is not None
             else cfg.data.validation_split)
    gen = seg.create_generators(
        crop_shape=None, mode="validation", n_classes=cfg.model.n_classes,
        horizontal_flip=False, vertical_flip=False, brightness=0.0,
        rotation=0.0, zoom=0.0, validation_split=split, seed=cfg.data.seed,
        do_ahisteq=False)
    # float32 forwards, as the JAX CLI scores them; with TTA and/or the CRF
    # the serving pipeline's labels
    predictor = Predictor(net,
                          crf=_crf_config(cfg) if args.eval_crf else None,
                          compute_dtype="float32", device=args.device,
                          tta_scales=_tta(args), tta_flip=args.tta_flip)
    conf, iou, mean_iou = calculate_iou(net, gen,
                                        nb_classes=cfg.model.n_classes,
                                        predict_fn=predictor)
    names = list(get_VOC2012_classes().values())[:cfg.model.n_classes]
    for n, v in zip(names, iou):
        print(f"{n:>14s}: {v:.4f}")
    print(f"Mean IOU (published metric): {mean_iou:.4f}")


def _load_image(path, h, w):
    from deeplab_tpu_torch.data.augment import resize_bilinear
    from deeplab_tpu_torch.data.generator import _imread_bgr
    return resize_bilinear(_imread_bgr(path), (w, h)).astype(np.float32)


def cmd_predict(args):
    os.makedirs(args.out_dir, exist_ok=True)
    if args.artifact:
        # an export-serving artifact: no model code, no h5; the geometry
        # and the CRF choice are in the file
        from deeplab_tpu_torch.export import load_serving
        art = load_serving(args.artifact)
        use_crf = art.meta.get("crf") is not None
        if (args.notebook_crf or args.tta_scales or args.tta_flip
                or (args.crf and not use_crf)):
            print("note: --crf/--notebook-crf/--tta-* are export-time "
                  "choices baked into the artifact (this one has CRF "
                  f"{'on' if use_crf else 'off'}); flags ignored")
        h, w = art.sz
        for path in args.images:
            bgr = _load_image(path, h, w)
            _write_prediction(args, path, bgr, art(bgr[None])[0], None,
                              use_crf)
        return
    cfg = _config(args)
    seg, net = _build(cfg, weights=args.weights)
    h, w = cfg.model.image_size
    use_crf = args.crf and cfg.crf.enabled
    if args.notebook_crf:
        import torch
        from deeplab_tpu_torch import core
        from deeplab_tpu_torch.crf import do_crf
        if args.tta_scales or args.tta_flip:
            print("note: --tta-* flags apply to the Predictor pipeline "
                  "only; ignored with --notebook-crf")
        # the reference notebook's per-image path (forward -> host argmax
        # -> do_crf with label compression and remap, utils.py:74-91)
        dev = core.resolve_device(args.device)
        net = net.to(dev)
    else:
        from deeplab_tpu_torch.predictor import Predictor
        predictor = Predictor(net, crf=_crf_config(cfg) if use_crf else None,
                              compute_dtype="float32", device=args.device,
                              return_raw=use_crf, tta_scales=_tta(args),
                              tta_flip=args.tta_flip)
    for path in args.images:
        bgr = _load_image(path, h, w)
        if args.notebook_crf:
            probs = net.apply(torch.from_numpy(bgr[None]).to(dev))
            pred = probs.argmax(-1)[0].reshape(h, w).cpu().numpy()
            pred_raw = pred
            if use_crf:
                pred = do_crf(bgr, pred.astype(np.int32), zero_unsure=False,
                              cfg=_crf_config(cfg), device=dev)
        elif use_crf:
            raw, refined = predictor(bgr[None])
            pred_raw, pred = raw[0], refined[0]
        else:
            pred_raw = pred = predictor(bgr[None])[0]
        _write_prediction(args, path, bgr, pred, pred_raw, use_crf)


def _write_prediction(args, path, bgr, pred, pred_raw, use_crf):
    """Per-image outputs: the mask PNG, the VOC-colorized PNG and the
    cell-9 figure (where matplotlib imports)."""
    from PIL import Image
    from deeplab_tpu_torch.viz import colorize_mask
    stem = os.path.join(args.out_dir,
                        os.path.splitext(os.path.basename(path))[0])
    out = stem + "_mask.png"
    Image.fromarray(pred.astype(np.uint8), mode="L").save(out)
    Image.fromarray(colorize_mask(pred)).save(stem + "_color.png")
    try:  # the figure needs matplotlib
        from deeplab_tpu_torch.viz import plot_predictions
        panels = [("prediction" + (" + CRF" if use_crf else ""), pred)]
        if use_crf and pred_raw is not None:
            panels.insert(0, ("prediction", pred_raw))
        plot_predictions(bgr, panels, path=stem + "_viz.png")
    except Exception as e:  # matplotlib missing or a broken backend
        print(f"note: skipping _viz.png ({e})")
    print(f"{path} -> {out} (classes: {sorted(set(pred.flat))})")


def cmd_serve(args):
    from deeplab_tpu_torch.serve import BatchingServer
    max_batch = args.max_batch
    if args.artifact:
        from deeplab_tpu_torch.export import load_serving
        art = load_serving(args.artifact)
        pipeline, sz = art, art.sz
        if art.batch is not None:     # a fixed-batch artifact bounds batches
            max_batch = min(max_batch, art.batch)
        meta = {"pipeline": "artifact",
                "crf": art.meta.get("crf") is not None}
    else:
        from deeplab_tpu_torch.predictor import Predictor
        cfg = _config(args)
        seg, net = _build(cfg, load_weights=not args.weights,
                          weights=args.weights)
        _warn_untrained(args, seg, "serving")
        use_crf = args.crf and cfg.crf.enabled
        pipeline = Predictor(net, crf=_crf_config(cfg) if use_crf else None,
                             compute_dtype=_precision(args),
                             device=args.device)
        sz = net.sz
        meta = {"pipeline": "predictor", "crf": use_crf}
    server = BatchingServer(pipeline, sz, max_batch=max_batch,
                            max_wait_ms=args.max_wait_ms, meta=meta)
    server.serve_forever(host=args.host, port=args.port)


def cmd_export_serving(args):
    from deeplab_tpu_torch.export import save_serving
    cfg = _config(args)
    # like serve: fall back to the config's checkpoint without --weights,
    # and say so before exporting a seeded initialization
    seg, net = _build(cfg, load_weights=not args.weights,
                      weights=args.weights)
    _warn_untrained(args, seg, "exporting")
    use_crf = args.crf and cfg.crf.enabled
    platforms = args.platforms or [args.device]
    save_serving(args.out, net, crf=_crf_config(cfg) if use_crf else None,
                 batch=args.batch, compute_dtype=_precision(args),
                 device=platforms)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"{args.out}: {size_mb:.1f} MB, platforms={platforms}, "
          f"batch={'symbolic' if args.batch is None else args.batch}, "
          f"crf={'on' if use_crf else 'off'}")


def cmd_export_config(args):
    from deeplab_tpu_torch.config import Config
    sys.stdout.write(Config().to_json() + "\n")


def _parser():
    p = argparse.ArgumentParser(prog="deeplab_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
        sp.set_defaults(fn=fn)
        return sp

    pt = add("train", cmd_train, help="fine-tune or train the model")
    pt.add_argument("--config")
    pt.add_argument("--weights", help="initial weights (h5 or npz)")
    pt.add_argument("--resume-weights", action="store_true",
                    help="load {checkpoint_dir}/{backbone}_{net}.h5 (or "
                         ".npz) if present")
    pt.add_argument("--resume", action="store_true",
                    help="resume full train state from state_checkpoint")
    pt.add_argument("--finetune", action="store_true", default=True)
    pt.add_argument("--no-finetune", dest="finetune", action="store_false")
    pt.add_argument("--profile-dir", default=None,
                    help="capture a profiler trace of train steps 2-4 into "
                         "this directory")

    pe = add("evaluate", cmd_evaluate, help="dataset confusion-matrix IoU")
    pe.add_argument("--config")
    pe.add_argument("--weights")
    pe.add_argument("--eval-split", type=float, default=None,
                    help="validation fraction (default: config's "
                         "validation_split; reference notebook used 0.05)")
    pe.add_argument("--tta-scales", type=float, nargs="+", default=None,
                    help="evaluate with multi-scale TTA probability "
                         "averaging (e.g. 0.75 1.0 1.25)")
    pe.add_argument("--tta-flip", action="store_true",
                    help="also average over horizontal flips")
    pe.add_argument("--eval-crf", action="store_true",
                    help="score CRF-refined predictions (config's CRF "
                         "parameters) instead of the raw forward")

    pp = add("predict", cmd_predict, help="predict masks for images")
    pp.add_argument("--config")
    pp.add_argument("--weights")
    pp.add_argument("--images", nargs="+", required=True)
    pp.add_argument("--artifact",
                    help="serve from an export-serving .npz artifact "
                         "instead of building the model (ignores --weights; "
                         "the CRF choice is baked into the artifact)")
    pp.add_argument("--crf", action="store_true")
    pp.add_argument("--notebook-crf", action="store_true",
                    help="use the notebook's per-image compressed-label CRF "
                         "(do_crf, cells 7-9 exact) instead of the batched "
                         "Predictor pipeline")
    pp.add_argument("--tta-scales", type=float, nargs="+", default=None,
                    help="multi-scale TTA: average softmax probabilities "
                         "over these input scales (e.g. 0.75 1.0 1.25); "
                         "Predictor pipeline only (not --notebook-crf)")
    pp.add_argument("--tta-flip", action="store_true",
                    help="also average over horizontal flips")
    pp.add_argument("--out-dir", default="preds")

    ps = add("serve", cmd_serve, help="HTTP inference server with dynamic "
             "batching (POST /predict -> PNG mask)")
    ps.add_argument("--artifact", help="serve an export-serving .npz artifact")
    ps.add_argument("--config")
    ps.add_argument("--weights", help="weights h5 for the live-Predictor "
                                      "mode (no --artifact)")
    ps.add_argument("--crf", action="store_true",
                    help="CRF refinement (live-Predictor mode)")
    ps.add_argument("--precision", choices=tuple(_PRECISION),
                    default="mixed",
                    help="compute policy (live-Predictor mode): mixed = f32 "
                         "activations with bf16 conv operands (the serving "
                         "default), bf16, or f32 = exact parity")
    ps.add_argument("--f32", action="store_true",
                    help="alias for --precision f32")
    ps.add_argument("--host", default="0.0.0.0")
    ps.add_argument("--port", type=int, default=8517)
    ps.add_argument("--max-batch", type=int, default=8,
                    help="dynamic-batching cap per device call")
    ps.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="how long the dispatcher waits to fill a batch "
                         "after the first request arrives")

    px = add("export-serving", cmd_export_serving,
             help="export the serving pipeline (model [+CRF]) to a "
                  "self-contained .npz artifact (a torch.export program)")
    px.add_argument("--config")
    px.add_argument("--weights", help="trained weights h5 to put in the "
                                      "artifact")
    px.add_argument("--out", default="serving.npz")
    px.add_argument("--batch", type=int, default=None,
                    help="fixed batch size (default: symbolic, one artifact "
                         "serves any batch)")
    px.add_argument("--crf", action="store_true",
                    help="include the dense-CRF refinement")
    px.add_argument("--precision", choices=tuple(_PRECISION),
                    default="mixed",
                    help="compute policy of the artifact: mixed (the "
                         "serving default), bf16, or f32 = exact parity")
    px.add_argument("--f32", action="store_true",
                    help="alias for --precision f32")
    px.add_argument("--platforms", nargs="+", default=None,
                    help="the one device to export for (cuda or cpu; "
                         "default: --device); an artifact runs on one")

    add("export-config", cmd_export_config, help="print default config JSON")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
