"""Serving front end / API: host ms of one pipeline call (the dispatcher's
device call through ``Predictor.__call__``), the mean over the window's
calls, timed by the benchmark's wrapper."""


def read(run):
    ms = run.records.get("call_ms")
    return sum(ms) / len(ms) if ms else None
