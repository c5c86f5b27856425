"""MobileNetV2 kernels (``kernels/fused_mbconv.py``, ``fused_dw.py``,
``models/mobilenetv2.py``): the bound of the work under the stride-1 block
labels ``mbNNs1`` (blocks 0, 2, 4-16) over their device time, in %."""

from portbench import readers as R


def read(run):
    return R.roofline(run, R.MB_S1)
