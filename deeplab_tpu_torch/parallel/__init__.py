"""Data parallelism over ``torch.distributed``, one process per device
(deeplab_tpu/parallel)."""
