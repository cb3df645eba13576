"""Seconds from the process's start to the end of the warm-up: imports,
the kernels' build or load, weights, the traffic pool, every graph key's
eager first call and its capture."""


def read(run):
    return run.setup_s
