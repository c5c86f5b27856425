"""Training loop (``data/generator.py::Prefetcher``): host ms of the span
``prefetch.wait`` (the step loop's blocking wait for the next batch) on
the calling thread, the mean over the traced steps."""

from portbench import spans as S


def read(run):
    return S.mean_span_ms(run, "prefetch.wait")
