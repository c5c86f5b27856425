"""Host data pipeline (deeplab_tpu/data): the augmenting JPEG/PNG
``SegmentationGenerator``, in-memory batches, a prefetch thread, the image
readers, the numpy augmentations (``augment``), the balanced class weights
and the VOC catalogue."""
