"""The benchmark of deeplab_tpu_torch on an NVIDIA H100 (see README.md)."""
