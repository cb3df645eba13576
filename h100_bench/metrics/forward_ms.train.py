"""Device milliseconds of a replayed mini-step's forward pass and losses,
the Chamfer's included (the ``train.forward`` span), averaged over the
replayed mini-steps of the recorded stretch (``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "train.forward", DEVICE)
