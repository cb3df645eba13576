"""Device milliseconds of a replayed mini-step's gradients (the
``train.backward`` span), averaged over the replayed mini-steps of the
recorded stretch (``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "train.backward", DEVICE)
