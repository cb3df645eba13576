"""Point gather, FPS and ball query (counterpart of
``pointcloud_style_transfer_tpu/ops/sampling.py``).

FPS and ball query dispatch to the CUDA kernels (``ops/kernels``) for CUDA
tensors unless ``use_kernel=False`` (``Config.use_pallas=False``), which runs
their plain PyTorch versions. Semantics are the JAX package's: FPS stores the
current index before updating and takes the lowest index of the maximum;
ball query keeps the nsample lowest-index points inside the radius and
backfills with the first.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import (ball_query_kernel, ball_query_plain,
                      farthest_point_sample_kernel, fps_plain)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points [B, N, C], idx [B, ...] -> [B, ..., C].
    Indices are clamped into [0, N-1] (the ball query's sentinel N lands on
    the last point, as in the JAX package)."""
    B, N, C = points.shape
    idx = idx.long().clamp(0, N - 1)
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def complement_indices(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices NOT in ``idx`` [B, M] (unique, in [0, n)), per row, ascending:
    [B, n-M] int64."""
    B, M = idx.shape
    K = n - M
    mask = torch.ones((B, n), dtype=torch.bool, device=idx.device)
    mask.scatter_(1, idx.long().clamp(0, n - 1), False)
    rank = torch.cumsum(mask, dim=1)
    pos = torch.where(mask, rank - 1, K).clamp_(max=K)  # K: dropped
    ar = torch.arange(n, device=idx.device).expand(B, n)
    out = torch.zeros((B, K + 1), dtype=torch.int64, device=idx.device)
    return out.scatter_(1, pos, ar)[:, :K]


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          use_kernel: bool = True) -> torch.Tensor:
    """FPS: xyz [B, N, 3] -> [B, npoint] int32 indices; out[:, 0] is the
    start. ``start`` [B] is the start index per cloud; when not given it is
    drawn uniformly from [0, N) with ``generator``."""
    B, N, _ = xyz.shape
    if start is None:
        start = torch.randint(0, N, (B,), generator=generator,
                              device=xyz.device)
    start = start.to(device=xyz.device, dtype=torch.int32).contiguous()
    xyz = xyz.detach().float().contiguous()
    if use_kernel:
        return farthest_point_sample_kernel(xyz, npoint, start)
    return fps_plain(xyz, npoint, start)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, use_kernel: bool = True
                     ) -> torch.Tensor:
    """Ball query: xyz [B, N, 3] points, new_xyz [B, S, 3] centers ->
    [B, S, nsample] int32."""
    xyz = xyz.detach().float().contiguous()
    new_xyz = new_xyz.detach().float().contiguous()
    if use_kernel:
        return ball_query_kernel(radius, nsample, xyz, new_xyz)
    return ball_query_plain(radius, nsample, xyz, new_xyz)
