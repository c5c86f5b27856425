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
``kernels/csrc/fused_mbconv_train.cu``.
"""

from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.predictor import Predictor

__all__ = ["SegNet", "Predictor"]
