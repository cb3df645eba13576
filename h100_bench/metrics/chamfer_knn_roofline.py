"""The Chamfer loss's k = 1 kNN launches (``knn_topk``, two a mini-step,
B x 30,000 queries against as many refs) in the traced stretch: their
least time on the published peaks (``flops/chamfer_knn.py``) over their
device time, in percent."""

from h100_bench.core.trace import kernel_name
from h100_bench.flops import chamfer_knn


def read(run):
    s = run.trace_summary
    if s is None:
        return None
    durs = [d for n, d in s.kernels if kernel_name(n).startswith("knn_topk")]
    if not durs or sum(durs) <= 0:
        return None
    M = run.cell.config["global_points"]
    least = chamfer_knn.least_seconds(run.cell.traffic["batch"], M, M)
    return 100.0 * least * len(durs) / sum(durs)
