"""Serving API (``predictor.py``): the share of the device's idle time in
the traced window during which the calling thread's innermost program span
is ``predict.copy_in`` or ``predict.copy_out``, in %."""

from portbench import spans as S


def read(run):
    return S.idle_share(run, ("predict.copy_in", "predict.copy_out"))
