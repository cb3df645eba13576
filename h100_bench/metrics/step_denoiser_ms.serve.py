"""Device milliseconds a step of the denoiser on the [cond; uncond] rows
inside the replayed loop (the ``sampler.denoiser`` span), averaged over the
steps of the replayed requests of the recorded stretch
(``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "sampler.denoiser", DEVICE)
