"""Host milliseconds a call inside the capture runner's ``capture.replay``
span (the graph's launch), averaged over the replayed requests of the
recorded stretch (``core/program_spans.py``)."""

from h100_bench.core.program_spans import HOST, mean_ms


def read(run):
    return mean_ms(run, "capture.replay", HOST)
