"""Device milliseconds a step of the voxel order and partition inside the
replayed loop (the ``sampler.partition`` span), averaged over the steps of
the replayed requests of the recorded stretch (``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "sampler.partition", DEVICE)
