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
``kernels/csrc/fused_dw.cu``.
"""

from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.predictor import Predictor

__all__ = ["SegNet", "Predictor"]
