"""Device milliseconds a step of the grid upsample of the unknown points
inside the replayed loop (the ``sampler.upsample`` span: the kd-grid's
interpolation, its exact patch of unsafe rows and the scatter back to point
order), averaged over the steps of the replayed requests of the recorded
stretch (``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "sampler.upsample", DEVICE)
