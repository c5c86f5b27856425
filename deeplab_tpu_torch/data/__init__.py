"""Host data pipeline (deeplab_tpu/data): in-memory batches, a prefetch
thread, the image readers and the numpy resizes (``augment``).  The
JPEG/PNG ``SegmentationGenerator`` and the augmentations are a later
slice."""
