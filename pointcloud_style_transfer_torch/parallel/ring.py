"""Ring passes for point-sharded distance computations (counterpart of
``pointcloud_style_transfer_tpu/parallel/ring.py``).

When the point axis is sharded over the ranks of a mesh axis, every query
shard must meet every reference shard. Each rank holds its query shard
[B, n_local, 3] and its reference shard [B, m_local, 3]; at each hop it runs
the port's kernel on the resident reference shard (``ops.min_sq_dist`` /
``ops.knn`` with ``backend="pallas"``: the ``rowmin`` and ``knn_topk``
kernels on CUDA tensors, their plain versions on CPU tensors), keeps a
running row minimum or top-k, and passes the shard on: it sends to rank
(i+1) % n of the axis and receives from (i-1) % n, as JAX's ``ppermute``
does. The next hop's exchange is posted before the hop's kernel, so the
copy overlaps the work. No rank holds more than two reference shards.

Departures from the JAX ring: n-1 exchanges for n shards (JAX rotates n
times and drops the last result; a one-rank axis exchanges nothing), and no
gradient (the JAX ring is differentiable; no caller of either takes one).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..ops import knn, min_sq_dist
from .mesh import POINTS_AXIS, AllReduceSum, axis_group, check_backend


def _ring(ref: torch.Tensor, group, visit: Callable[[torch.Tensor, int],
                                                     None]) -> None:
    """Call ``visit(shard, src)`` for each of the group's reference shards in
    arrival order (this rank's own first, then rank r-1's, ...); ``src`` is
    the rank of the group the shard came from."""
    check_backend(ref.device.type, group)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    # P2P peers are global ranks, even on a sub-group of the mesh
    send_to = dist.get_global_rank(group, (me + 1) % n)
    recv_from = dist.get_global_rank(group, (me - 1) % n)
    cur = ref.contiguous()
    for i in range(n):
        reqs, nxt = [], None
        if i + 1 < n:
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, send_to, group),
                dist.P2POp(dist.irecv, nxt, recv_from, group)])
        visit(cur, (me - i) % n)
        for r in reqs:
            r.wait()
        cur = nxt


@torch.no_grad()
def ring_min_sq_dist(query: torch.Tensor, ref: torch.Tensor, mesh,
                     axis_name: str = POINTS_AXIS) -> torch.Tensor:
    """[B, n_local] min squared distance from this rank's query shard to
    the whole (sharded) reference cloud: the row minimum of every hop,
    combined with ``torch.minimum`` (NaN propagates, as in JAX's
    ``jnp.minimum`` and the kernel)."""
    best = []

    def visit(r, src):
        d = min_sq_dist(query, r, backend="pallas")
        best.append(d if not best else torch.minimum(best.pop(), d))
    _ring(ref, axis_group(mesh, axis_name), visit)
    return best[0]


@torch.no_grad()
def ring_knn(query: torch.Tensor, ref: torch.Tensor, k: int, mesh,
             axis_name: str = POINTS_AXIS
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest refs of this rank's query shard over the whole
    (sharded) reference cloud: (sq_dists [B, n_local, k], global indices
    [B, n_local, k] int32), ascending. Shard s holds the global indices
    [s * m_local, (s+1) * m_local), and k <= m_local.

    Ties go to the earlier arrival, as JAX's merge (``lax.top_k`` over
    [running best, new shard], which is stable) gives them: a stable sort
    of the 2k candidates keeps the running best ahead of the new shard."""
    m_local = ref.shape[1]
    if k > m_local:
        raise ValueError(f"k={k} exceeds the reference shard ({m_local})")
    best = []

    def visit(r, src):
        d, idx = knn(query, r, k, backend="pallas")
        idx = idx + src * m_local
        if best:
            bd, bi = best.pop()
            d, idx = torch.cat([bd, d], -1), torch.cat([bi, idx], -1)
            order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
            d, idx = d.gather(-1, order), idx.gather(-1, order)
        best.append((d, idx))
    _ring(ref, axis_group(mesh, axis_name), visit)
    return best[0]


def _mean_over_ring(rows: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """[B] mean of the sharded [B, n] rows, the same on every rank: the
    mean of the shards' means (equal shards), so that one rank's is the
    dense mean's bits."""
    group = axis_group(mesh, axis_name)
    total = AllReduceSum.apply(rows.mean(dim=1), group)
    return total / dist.get_world_size(group)


def ring_chamfer_distance(pred: torch.Tensor, target: torch.Tensor, mesh,
                          axis_name: str = POINTS_AXIS) -> torch.Tensor:
    """[B] bidirectional squared Chamfer (the training loss's definition,
    ``ops.chamfer_distance``) of point-sharded clouds; every rank returns
    the same value."""
    d_pt = ring_min_sq_dist(pred, target, mesh, axis_name)
    d_tp = ring_min_sq_dist(target, pred, mesh, axis_name)
    return (_mean_over_ring(d_pt, mesh, axis_name)
            + _mean_over_ring(d_tp, mesh, axis_name))


def ring_chamfer_distance_l2(pred: torch.Tensor, target: torch.Tensor,
                             mesh, axis_name: str = POINTS_AXIS
                             ) -> torch.Tensor:
    """[B] evaluation Chamfer (*unsquared* L2, both directions averaged,
    halved: ``ops.chamfer_distance_l2``) of point-sharded clouds; every rank
    returns the same value. The test CLI's full-resolution Chamfer on a
    ``points`` mesh (``evaluation.metrics.chamfer_distance``)."""
    d_pt = torch.sqrt(ring_min_sq_dist(pred, target, mesh, axis_name))
    d_tp = torch.sqrt(ring_min_sq_dist(target, pred, mesh, axis_name))
    return (_mean_over_ring(d_pt, mesh, axis_name)
            + _mean_over_ring(d_tp, mesh, axis_name)) / 2.0
