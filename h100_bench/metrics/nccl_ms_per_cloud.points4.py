"""Device milliseconds of NCCL kernels a cloud on rank 0, from the traced
stretch: the point-sharded sampler's all-gathers."""


def read(run):
    s = run.trace_summary
    if s is None or not s.units:
        return None
    ms = [d for n, d in s.kernels if "nccl" in n.lower()]
    if not ms:
        return None
    return 1e3 * sum(ms) / s.units
