"""CRF (``crf/dense_crf.py``, ``kernels/crf_fused.py``): the bound of the
work after the model's last label (the head, its resize and argmax, and
the CRF at the configuration's parameters) over the device time of the
ops launched there, copies excluded, in %."""

from portbench import readers as R
from portbench.work import crf as WC
from portbench.work import deeplabv3p as WD
from portbench.work.peaks import bound_s


def read(run):
    tr = run.trace
    if tr is None or not tr.on_device or not run.workload.get("crf"):
        return None
    us = R.post_model_us(tr.ops)
    if us <= 0:
        return None
    H, W = run.size
    B = run.records["batch"]
    head = WD.regions(run.config, B, H, W)["head"]
    flops = head.flops + WC.flops(run.config["crf"], B, H, W,
                                  run.config["n_classes"])
    nbytes = head.bytes + WC.io_bytes(B, H, W)
    return 100.0 * bound_s(flops, nbytes) * R.calls_traced(run) / (us / 1e6)
