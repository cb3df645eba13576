"""The Chamfer loss's k = 1 nearest-neighbour launch (``csrc/knn_topk.cu``
through ``ops/distance.py::MinSqDist``): operations and bytes of one
direction over a batch, and its least time on the published peaks."""

from __future__ import annotations

from ..core import peaks

FLOPS_PER_PAIR = 8  # 3 differences, 3 products, 2 sums


def flops(batch: int, queries: int, refs: int) -> int:
    return FLOPS_PER_PAIR * batch * queries * refs


def bytes_moved(batch: int, queries: int, refs: int) -> int:
    """Each input point read once (3 float32), each query's distance and
    index written once."""
    return batch * ((queries + refs) * 3 * 4 + queries * (4 + 4))


def least_seconds(batch: int, queries: int, refs: int) -> float:
    return max(flops(batch, queries, refs) / peaks.F32_FLOPS,
               bytes_moved(batch, queries, refs) / peaks.HBM_BYTES_PER_S)
