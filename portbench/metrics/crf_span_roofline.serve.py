"""CRF (``crf/dense_crf.py``, ``kernels/crf_fused.py``): the bound of the
CRF's work at the configuration's parameters (``portbench/work/crf.py``)
times the calls traced, over the device time of the ops launched inside
the span ``predict.crf`` (their scope), in %.  Unlike ``crf_roofline``
it leaves the head and the argmax out of both."""

from portbench import readers as R
from portbench import spans as S
from portbench.work import crf as WC
from portbench.work.peaks import bound_s


def read(run):
    tr = run.trace
    if tr is None or not tr.on_device or not run.workload.get("crf"):
        return None
    us = S.scope_us(tr, "predict.crf")
    if us <= 0:
        return None
    H, W = run.size
    B = run.records["batch"]
    flops = WC.flops(run.config["crf"], B, H, W, run.config["n_classes"])
    t = bound_s(flops, WC.io_bytes(B, H, W))
    return 100.0 * t * R.calls_traced(run) / (us / 1e6)
