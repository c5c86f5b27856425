"""End-to-end workflow mirroring the reference notebook (segmentation.ipynb),
on the port (the JAX repo's ``examples/segmentation_workflow.py``).

Cell-by-cell equivalence:
  cell 0   config + SegModel facade
  cell 2   model build (+optional pretrained weights) — original or subpixel
  cell 4   asymmetric train/valid generators
  cell 5   freeze-to-concat_projection fine-tune with callbacks
  cells 7-9  reload the best checkpoint, compare +/- CRF on a validation
             sample
  cells 10-11  dataset confusion-matrix IoU ("Mean IOU" published metric)

Run on the card (``--device cpu`` for the CPU):

    python -m deeplab_tpu_torch.examples.segmentation_workflow \\
        --dataset /path/to/VOC2012 [--backbone mobilenetv2] \\
        [--better-model] [--epochs 10] [--seed 0]

The checkpoint is ``{out_dir}/{backbone}_{net}.h5``, or ``.npz`` where
``h5py`` does not import (the facade's rule).  The evaluation cells run the
float32 forward, as the JAX script's ``model.apply`` and ``calculate_iou``
do, so no model kernel runs there; ``do_crf`` runs the CRF kernels on the
card.  The validation sample is drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--backbone", default="mobilenetv2",
                    choices=["mobilenetv2", "xception"])
    ap.add_argument("--better-model", action="store_true",
                    help="subpixel + ICNR head (notebook better_model flag)")
    ap.add_argument("--image-size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--load-pretrained", action="store_true")
    ap.add_argument("--out-dir", default="weights")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="draws the validation sample of cells 7-9")
    return ap.parse_args(argv)


def f32_predict_fn(model):
    """``X -> (B, H*W)`` label ids: the argmax of the float32 softmax
    (``SegNet.apply``), the forward JAX's ``calculate_iou`` takes by
    default."""
    import torch
    dev = next(model.parameters()).device

    def predict(X):
        x = torch.as_tensor(np.asarray(X, np.float32)).to(dev)
        return torch.argmax(model.apply(x, "float32"), dim=-1)
    return predict


def sample_compare(model, valid_generator, image_size, seed: int = 0,
                   device=None):
    """Cells 7-9: one validation batch drawn from ``seed``, its first
    image's float32 prediction and the CRF's refinement of it
    (``do_crf``, ``zero_unsure=False``).  Returns (image, gt, preds, MAP,
    mIOU without the CRF, mIOU with it)."""
    from deeplab_tpu_torch.crf import do_crf
    from deeplab_tpu_torch.viz import mIOU
    i = np.random.RandomState(seed).randint(0, max(len(valid_generator), 1))
    x, y, _ = valid_generator[i]
    x, y = np.array(x), np.array(y)       # the generator reuses its buffers
    preds = f32_predict_fn(model)(x).cpu().numpy()[0].reshape(image_size)
    gt = y[0].reshape(image_size).astype("int32")
    MAP = do_crf(x[0], preds.astype("int32"), zero_unsure=False,
                 device=device)
    return x[0], gt, preds, MAP, mIOU(gt, preds), mIOU(gt, MAP)


def dataset_iou(model, eval_gen, n_classes: int):
    """Cells 10-11: the confusion matrix over ``eval_gen`` with the float32
    forward; returns (conf_m, per-class IoU, published mean IoU)."""
    from deeplab_tpu_torch.viz import calculate_iou
    return calculate_iou(model, eval_gen, nb_classes=n_classes,
                         predict_fn=f32_predict_fn(model))


def main(argv=None) -> dict:
    """Run the workflow; returns what it computed (``history``,
    ``modelpath``, ``model``, the generators, the sample's image, ground
    truth, prediction and CRF mask and their mIoUs, the published mean
    IoU)."""
    args = parse_args(argv)
    from deeplab_tpu_torch import core
    from deeplab_tpu_torch.data.voc import get_VOC2012_classes
    from deeplab_tpu_torch.models.seg_model import SegModel
    from deeplab_tpu_torch.params import weights_suffix
    from deeplab_tpu_torch.train import (EarlyStopping, ModelCheckpoint,
                                         ReduceLROnPlateau, Trainer)

    device = core.resolve_device(args.device)

    # ---- cell 0: config ----
    image_size = tuple(args.image_size)
    n_classes = len(get_VOC2012_classes()) - 1
    net = "subpixel" if args.better_model else "original"
    print(f"Backbone: {args.backbone}\nN classes: {n_classes}"
          f"\nImage size: {image_size}\nBatch size: {args.batch_size}")

    SegClass = SegModel(args.dataset, image_size)
    SegClass.set_batch_size(args.batch_size)
    SegClass.set_num_epochs(args.epochs)

    # ---- cell 2: model ----
    model = SegClass.create_seg_model(net=net, n=n_classes,
                                      backbone=args.backbone,
                                      load_weights=args.load_pretrained)
    print("Weights path:", SegClass.modelpath)

    # ---- cell 4: generators (asymmetric augmentation) ----
    train_generator = SegClass.create_generators(
        blur=5, crop_shape=None, mode="train", n_classes=n_classes,
        horizontal_flip=True, vertical_flip=False, brightness=0.3,
        rotation=False, zoom=0.1, validation_split=0.15, seed=7,
        do_ahisteq=False)
    valid_generator = SegClass.create_generators(
        blur=0, crop_shape=None, mode="validation", n_classes=n_classes,
        horizontal_flip=True, vertical_flip=False, brightness=0.1,
        rotation=False, zoom=0.05, validation_split=0.15, seed=7,
        do_ahisteq=False)

    # ---- cell 5: callbacks + fine-tune ----
    os.makedirs(args.out_dir, exist_ok=True)
    SegClass.modelpath = os.path.join(
        args.out_dir, f"{args.backbone}_{net}{weights_suffix()}")
    monitor = "val_Jaccard"
    callbacks = [
        ModelCheckpoint(SegClass.modelpath, monitor=monitor, mode="max",
                        verbose=1),
        ReduceLROnPlateau(monitor=monitor, factor=0.5, patience=5,
                          min_lr=1e-6),
        EarlyStopping(monitor=monitor, patience=100),
    ]
    trainer = Trainer(model, epochs=args.epochs, callbacks=callbacks,
                      lr=7e-4, epsilon=1e-8, decay=1e-6,
                      freeze_before=("concat_projection"
                                     if args.load_pretrained else None),
                      device=device)
    history = trainer.fit(model, train_generator, valid_generator)
    print("final:", {k: round(v[-1], 4) for k, v in history.items() if v})

    # ---- cells 7-9: reload best checkpoint, compare +/- CRF ----
    if os.path.exists(SegClass.modelpath):
        SegClass.load_weights(model)
    else:
        print("note: no best checkpoint written (validation too small?); "
              "using final weights")
    x0, gt, preds, MAP, miou_raw, miou_crf = sample_compare(
        model, valid_generator, image_size, args.seed, device)
    print("sample mIOU (no CRF):", miou_raw)
    print("sample mIOU (+CRF):  ", miou_crf)

    # ---- cell 9: side-by-side image / GT / prediction / +CRF figure ----
    try:  # matplotlib is the optional 'viz' extra
        import matplotlib  # noqa: F401
    except ImportError as e:
        print("note: skipping figure:", e)
    else:
        from deeplab_tpu_torch.viz import plot_predictions
        fig_path = os.path.join(os.path.dirname(SegClass.modelpath) or ".",
                                "sample_prediction.png")
        plot_predictions(x0, [("ground truth", gt), ("prediction", preds),
                              ("prediction + CRF", MAP)], path=fig_path)
        print("wrote", fig_path)

    # ---- cells 10-11: dataset confusion-matrix IoU ----
    SegClass.set_batch_size(1)
    eval_gen = SegClass.create_generators(
        crop_shape=None, mode="validation", n_classes=n_classes,
        horizontal_flip=False, vertical_flip=False, brightness=0,
        rotation=False, zoom=0, validation_split=0.05, seed=7,
        do_ahisteq=False)
    conf_m, iou, mean_iou = dataset_iou(model, eval_gen, n_classes)
    print(f'Published-metric "Mean IOU": {mean_iou:.4f}')
    return {"history": history, "modelpath": SegClass.modelpath,
            "model": model, "valid_generator": valid_generator,
            "eval_generator": eval_gen, "miou_raw": miou_raw,
            "miou_crf": miou_crf, "mean_iou": mean_iou, "conf_m": conf_m,
            "sample": (x0, gt, preds, MAP),
            "n_classes": n_classes, "image_size": image_size}


if __name__ == "__main__":
    main()
