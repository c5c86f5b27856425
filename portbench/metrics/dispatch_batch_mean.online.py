"""Serving front end (``serve.py``'s ``_Dispatcher``): real (unpadded)
images a device call, the mean over the window's pipeline calls, counted
by the benchmark's wrapper around the pipeline it hands the server."""


def read(run):
    rec = run.records
    if not rec.get("pipeline_calls"):
        return None
    return rec["completed_in_calls"] / rec["pipeline_calls"]
