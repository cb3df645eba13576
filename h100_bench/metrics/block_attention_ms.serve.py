"""Device milliseconds of a transformer block's attention sublayer
(``ln_1``, ``c_qkv``, attention, ``c_proj`` and the residual add: the
``denoiser.attention`` span) inside the replayed loop, averaged over the
blocks and steps of the replayed requests of the recorded stretch
(``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "denoiser.attention", DEVICE)
