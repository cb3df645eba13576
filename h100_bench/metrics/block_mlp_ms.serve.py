"""Device milliseconds of a transformer block's MLP sublayer (``ln_2``,
``c_fc``, GELU, ``c_proj`` and the residual add: the ``denoiser.mlp``
span) inside the replayed loop, averaged over the blocks and steps of the
replayed requests of the recorded stretch (``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "denoiser.mlp", DEVICE)
