"""Host data pipeline (deeplab_tpu/data): in-memory batches and a prefetch
thread.  The JPEG/PNG ``SegmentationGenerator`` is a later slice."""
