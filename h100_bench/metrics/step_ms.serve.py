"""Device milliseconds of one sampler step inside the replayed loop (the
program's ``sampler.step`` span: partition, denoiser, CFG combine, upsample
and DDIM step), averaged over the steps of the replayed requests of the
recorded stretch (``core/program_spans.py``)."""

from h100_bench.core.program_spans import DEVICE, mean_ms


def read(run):
    return mean_ms(run, "sampler.step", DEVICE)
