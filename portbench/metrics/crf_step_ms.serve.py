"""CRF (``crf/dense_crf.py::_mean_field_planes``): device ms a traced call
of the ops launched inside the span ``crf.step`` (each iteration's step:
the color blur and slice of the grid, the messages, the unary and the
softmax)."""

from portbench import spans as S


def read(run):
    return S.scope_ms_per_call(run, "crf.step")
