"""Xception kernels (``fused_sepconv``, ``models/xception.py``): the bound
of the work under the block labels ``xentry1``-``3``, ``xmid01``-``16``
and ``xexit1``-``2`` over their device time, in %."""

from portbench import readers as R


def read(run):
    return R.roofline(run, R.XCEPTION_BLOCK)
