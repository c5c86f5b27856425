"""Dense CRF post-processing (deeplab_tpu/crf/__init__.py): the cell-plane
mean field and its four named configurations."""

from deeplab_tpu_torch.crf.dense_crf import (CrfConfig, color_band_taps,
                                             mean_field_batched,
                                             unary_from_labels)

# The exact pydensecrf parameter mirror (reference utils.py:78-86): sxy=3/80,
# srgb=13, compat 3/10, 5 iterations, gt_prob 0.7, bilateral grid sampled at
# 1 sigma with gaussian taps.
FAITHFUL_CONFIG = CrfConfig()

# The same kernel parameters with nonnegative least-squares color taps on a
# 1.7x coarser grid (nc 21 -> 13); held to the committed exact-oracle
# goldens (tests/goldens/crf) at >= 0.993 agreement on every scene.
FAST_FAITHFUL_CONFIG = CrfConfig(color_step=1.7, color_taps="nnls")

# Throughput config: coarse grid (nc 9) and a 4x subsampled splat.
THROUGHPUT_CONFIG = CrfConfig(color_step=2.5, color_taps="lsq",
                              splat_stride=4)

# Production serving config (the JAX package's PRODUCTION_CONFIG): nnls taps
# at 1.5 sigma (nc 15) and a 2x subsampled splat.
PRODUCTION_CONFIG = CrfConfig(color_step=1.5, color_taps="nnls",
                              splat_stride=2)

__all__ = ["CrfConfig", "color_band_taps", "mean_field_batched",
           "unary_from_labels", "FAITHFUL_CONFIG", "FAST_FAITHFUL_CONFIG",
           "THROUGHPUT_CONFIG", "PRODUCTION_CONFIG"]
