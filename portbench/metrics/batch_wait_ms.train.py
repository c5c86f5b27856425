"""Training loop (``train/trainer.py``, ``data/generator.py::Prefetcher``):
host ms the step loop waited in ``next()`` of the pipeline, the mean over
the window's steps, timed by the benchmark."""


def read(run):
    ms = run.records.get("batch_wait_ms")
    return sum(ms) / len(ms) if ms else None
