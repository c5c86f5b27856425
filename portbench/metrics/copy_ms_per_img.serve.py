"""Serving API (``predictor.py``): device ms of the host-to-device image
copies and the device-to-host label copies (``gpu_memcpy`` ops) in the
traced window, per image served there."""

from portbench import readers as R


def read(run):
    tr = run.trace
    n = run.records.get("trace_images", 0)
    if tr is None or not tr.on_device or not n:
        return None
    us = R.memcpy_us(tr.ops)
    return us / 1e3 / n if us > 0 else None
