"""Training kernels (``kernels/fused_mbconv_train.py``): the bound of the
forward and backward work under the stride-1 block labels ``mbNNs1`` and
``bwd(mbNNs1)`` over their device time in the traced steps, in %."""

from portbench import readers as R


def read(run):
    if not run.records.get("trace_steps"):
        return None
    return R.roofline(run, R.MB_S1, backward=True)
