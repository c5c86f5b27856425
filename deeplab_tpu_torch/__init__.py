"""PyTorch + CUDA port of deeplab_tpu (DeepLabV3+ segmentation) for NVIDIA Hopper.

The JAX package ``deeplab_tpu`` is the reference; this package mirrors its
module names so that each piece has an obvious counterpart, and imports
neither ``jax`` nor ``deeplab_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Ported so far: the production serving path,
``Predictor(net, crf=crf.PRODUCTION_CONFIG, compute_dtype="mixed")`` over the
MobileNetV2 ``SegNet`` with the ``'original'`` head.  Its 14 stride-1
inverted-residual blocks run through the hand-written CUDA kernel
``kernels/csrc/fused_mbconv.cu``; the dense CRF's splat, slice, spatial blur
and mean-field step through ``kernels/csrc/crf_fused.cu``.  And training on
one GPU, ``train.Trainer``: under bf16 the same 14 blocks run forward and
backward through the five phase kernels of
``kernels/csrc/fused_mbconv_train.cu``.  And serving the Xception
``SegNet(..., backbone="xception", OS=16 | 8)`` and both nets with the
``'subpixel'`` head: every eval-mode stride-1 SepConv_BN of the Xception net
runs through ``kernels/csrc/fused_sepconv.cu``.  And the evaluation path:
``viz.calculate_iou`` and the confusion-matrix metrics, ``crf.mean_field`` and
``crf.do_crf`` on both CRF engines (the XLA engine's color blur and slice in
``kernels/csrc/crf_fused.cu``); MobileNetV2 block 0 runs through
``kernels/csrc/fused_dw.cu``.  And the serving surface: the ``Predictor``'s
multi-scale and flip test-time augmentation, ``Predictor.predict_files`` and
the HTTP batching server (``serve.BatchingServer``).  And the deployment
surface: every serving kernel is a ``torch.library`` operator
(``kernels/ops.py``), ``export.save_serving`` writes the pipeline as a
``torch.export`` program with a symbolic batch and ``export.load_serving``
runs it without the model code; ``config.Config`` and the command line
(``python -m deeplab_tpu_torch.cli``, with the ``SegModel`` facade and the
augmenting ``SegmentationGenerator`` behind ``evaluate``).

And the rest of the JAX package: the reference's ``Deeplabv3`` entry point
(probabilities, ``weights="pascal_voc"`` from a local file), the
probability-form losses, the numpy CRF oracle (``crf/brute.py``), the
native host image library (``data/native.py`` over
``data/csrc/imgops.cpp``, built with ``g++`` at first use) and data-parallel
training and serving over ``torch.distributed`` (``parallel/mesh.py``,
``Trainer(mesh=..., ddp=...)``, ``Predictor(mesh=...)``).

And the production grade of the JAX repo's ``tools/grade_production.py``
(``grade.py``: the float32 parity stack against the "mixed" production
stack in mIoU points over committed real-photo tiles).

And what drives the package and reads its behaviour: the reference
notebook's workflow as a script (``examples/segmentation_workflow.py``),
the gallery (``tools/make_gallery.py``), the JAX package's trace region
labels (``core.annotate``, a no-op without a profiler), the
trace reader ``tools/trace.py`` and the region tables of the train step,
the Xception serving forward and the CRF (``tools/profile_train.py``,
``profile_xception.py``, ``profile_crf.py``).

The public names mirror the JAX package's (``Deeplabv3``, ``SegModel``,
``losses``, ``metrics``) beside ``SegNet`` and ``Predictor``.  Each is
imported when first named, so that loading a serving artifact imports no
model code.
"""

import importlib

__all__ = ["SegNet", "Predictor", "Deeplabv3", "SegModel", "losses",
           "metrics"]

_LAZY = {"SegNet": ("deeplab_tpu_torch.models.seg_model", "SegNet"),
         "SegModel": ("deeplab_tpu_torch.models.seg_model", "SegModel"),
         "Deeplabv3": ("deeplab_tpu_torch.models.deeplabv3p", "Deeplabv3"),
         "Predictor": ("deeplab_tpu_torch.predictor", "Predictor"),
         "losses": ("deeplab_tpu_torch.losses", None),
         "metrics": ("deeplab_tpu_torch.metrics", None)}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    mod = importlib.import_module(module)
    return mod if attr is None else getattr(mod, attr)
