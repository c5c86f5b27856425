"""Serving API (``predictor.py``): the share of the device's idle time in
the traced window during which the calling thread is inside the span
``predict.model`` (the model's launches, its block labels included), in
%."""

from portbench import spans as S


def read(run):
    return S.idle_share_within(run, "predict.model")
