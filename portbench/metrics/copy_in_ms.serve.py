"""Serving API (``predictor.py``): host ms of the span ``predict.copy_in``
(the images from the host array to a device tensor, through pageable
staging) on the calling thread, the mean over the traced calls."""

from portbench import spans as S


def read(run):
    return S.mean_span_ms(run, "predict.copy_in")
