"""The fused attention kernels of the traced stretch (PyTorch's flash,
cuDNN or memory-efficient kernels behind
``scaled_dot_product_attention``): their least time on the published bf16
and HBM peaks (``flops/point_e.py``: 4 B H T^2 c operations, q, k, v and
the output once in bfloat16, a call; layers x steps calls a traced
request) over their device time, in percent. None where no such kernel
ran."""

import re

from h100_bench.core.trace import kernel_name
from h100_bench.drivers.serve import hierarchical
from h100_bench.flops import point_e

ATTENTION = re.compile(r"flash|fmha|attention|sdpa", re.IGNORECASE)


def read(run):
    s = run.trace_summary
    cfg = run.cell.config
    if s is None or "denoiser" not in cfg:
        return None
    durs = [d for n, d in s.kernels if ATTENTION.search(kernel_name(n))]
    if not durs or sum(durs) <= 0:
        return None
    tr = run.cell.traffic
    calls = s.units * tr["steps"] * int(cfg["denoiser"]["layers"])
    least = point_e.attention_least_seconds(
        cfg, 2 * tr["batch"], point_e.tokens(cfg, hierarchical(run)))
    return 100.0 * least * calls / sum(durs)
