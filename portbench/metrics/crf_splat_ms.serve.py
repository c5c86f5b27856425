"""CRF (``crf/dense_crf.py::_mean_field_planes``): device ms a traced call
of the ops launched inside the span ``crf.splat`` (each iteration's
splat of Q onto the bilateral grid and the grid's cross-cell blur)."""

from portbench import spans as S


def read(run):
    return S.scope_ms_per_call(run, "crf.splat")
