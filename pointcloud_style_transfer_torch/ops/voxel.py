"""Voxel-grid downsampling to an exact point count (counterpart of
``pointcloud_style_transfer_tpu/ops/voxel.py``, ``mean_index`` rule).

Per cloud:

1. voxel size ``cbrt(prod(range) / target) * 1.2``, hash of the voxel
   coordinates with the reference's primes (int32 wraparound);
2. a stable sort by hash gives contiguous voxel segments; each voxel's
   representative is the truncated float32 mean of its point indices;
3. exact-count selection: representatives get priority ``u``, the other
   points ``1 + u``, with ``u`` uniform in [0, 1); the ``target`` lowest
   priorities win (stable sort, so equal priorities keep index order — ties
   are routine among 120k float32 draws).

The draws ``u`` can be passed in (``priority``) so that a test can give both
packages the same numbers; otherwise they come from ``generator``. Clouds of
a batch are processed one by one, so each cloud's result is its own B=1
result.

The JAX package computes the voxel size with ``jnp.cbrt``, which XLA lowers
to ``pow(x, float32(1/3))``. Here the same power is evaluated in float64 and
rounded to float32; on the CPU it differs from XLA's by one ulp on about
0.07% of inputs (ROADMAP queue 3), so tests that need identical indices
pass the geometry in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_PRIMES = (73856093, 19349663, 83492791)
_THIRD = float(np.float32(1.0 / 3.0))

Geometry = Tuple[torch.Tensor, torch.Tensor]  # xyz_min [B, 3], voxel_size [B]


def voxel_geometry(pts: torch.Tensor, target_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xyz_min [3], voxel_size []) of one cloud [N, 3] float32."""
    xyz_min = pts.min(dim=0).values
    rng = pts.max(dim=0).values - xyz_min
    rng = torch.where(rng < 1e-6, 1.0, rng)
    ratio = (rng[0] * rng[1]) * rng[2] / target_size
    voxel_size = torch.pow(ratio.double(), _THIRD).float() * 1.2
    voxel_size = torch.where(voxel_size < 1e-6, 1e-3, voxel_size)
    return xyz_min, voxel_size


def _hash_voxels(pts: torch.Tensor, xyz_min: torch.Tensor,
                 voxel_size: torch.Tensor) -> torch.Tensor:
    vox = torch.floor((pts - xyz_min) / voxel_size).to(torch.int32)
    return ((vox[:, 0] * _PRIMES[0]) ^ (vox[:, 1] * _PRIMES[1])
            ^ (vox[:, 2] * _PRIMES[2]))


def _priority_order(pts: torch.Tensor, u: torch.Tensor, target_size: int,
                    geometry: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    ) -> torch.Tensor:
    """All N indices of one cloud [N, 3], ordered by selection priority: the
    first ``target_size`` are the selection, the rest its complement."""
    N = pts.shape[0]
    xyz_min, voxel_size = (voxel_geometry(pts, target_size)
                           if geometry is None else geometry)
    h = _hash_voxels(pts, xyz_min, voxel_size)
    hs, order = torch.sort(h, stable=True)
    is_leader = torch.ones(N, dtype=torch.bool, device=pts.device)
    is_leader[1:] = hs[1:] != hs[:-1]
    seg = torch.cumsum(is_leader, dim=0) - 1  # voxel id per sorted position
    # float32 sums of the point indices, as the JAX package keeps them (exact
    # integers below 2**24)
    idx_f = order.float()
    sums = torch.zeros(N, dtype=torch.float32, device=pts.device)
    sums.index_add_(0, seg, idx_f)
    counts = torch.zeros(N, dtype=torch.float32, device=pts.device)
    counts.index_add_(0, seg, torch.ones_like(idx_f))
    rep = (sums / counts.clamp(min=1.0)).to(torch.int64)
    rep_scatter = torch.where(counts > 0, rep, N)  # N: no voxel, dropped
    rep_mask = torch.zeros(N + 1, dtype=torch.bool, device=pts.device)
    rep_mask[rep_scatter] = True
    priority = torch.where(rep_mask[:N], u, 1.0 + u)
    return torch.sort(priority, stable=True).indices


def voxel_order(points: torch.Tensor, target_size: int,
                priority: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                geometry: Optional[Geometry] = None) -> torch.Tensor:
    """[B, N] priority order of every cloud of a batch [B, N, 3]: its first
    ``target_size`` indices are the downsample, the rest its complement
    (``order`` of ``voxel_downsample_partition``)."""
    B, N, _ = points.shape
    if priority is None:
        priority = torch.rand((B, N), generator=generator,
                              device=points.device)
    priority = priority.to(device=points.device, dtype=torch.float32)
    pts = points.detach().float()
    return torch.stack([
        _priority_order(pts[b], priority[b], target_size,
                        None if geometry is None
                        else (geometry[0][b], geometry[1][b]))
        for b in range(B)])


def voxel_downsample(points: torch.Tensor, target_size: int,
                     priority: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     geometry: Optional[Geometry] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Downsample [B, N, 3] to exactly ``target_size`` points.

    Returns (downsampled [B, M, 3], indices [B, M]). ``priority`` [B, N]
    holds the uniform draws (else drawn from ``generator``); ``geometry``
    overrides the per-cloud (xyz_min, voxel_size). N <= target_size returns
    the cloud with identity indices."""
    B, N, _ = points.shape
    if N <= target_size:
        idx = torch.arange(N, device=points.device).expand(B, N)
        return points, idx
    idx = voxel_order(points, target_size, priority, generator,
                      geometry)[:, :target_size]
    ds = torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))
    return ds, idx


def voxel_downsample_partition(
        points: torch.Tensor, target_size: int,
        priority: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        geometry: Optional[Geometry] = None,
        order: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sampler's split of each cloud into the selection and the rest.

    Returns (selected [B, M, 3], indices [B, M], complement [B, N-M],
    complement_xyz [B, N-M, 3]), float32 coordinates; the complement is in
    priority order. ``order`` [B, N] is a ``voxel_order`` to take instead of
    computing one. N <= target_size returns identity indices and empty
    complements."""
    B, N, _ = points.shape
    if N <= target_size:
        idx = torch.arange(N, device=points.device).expand(B, N)
        return (points, idx,
                torch.zeros((B, 0), dtype=torch.int64, device=points.device),
                points.new_zeros((B, 0, 3)))
    perm = (voxel_order(points, target_size, priority, generator, geometry)
            if order is None else order.to(points.device))
    xyz = torch.gather(points.detach().float(), 1,
                       perm[..., None].expand(-1, -1, 3))
    return (xyz[:, :target_size], perm[:, :target_size],
            perm[:, target_size:], xyz[:, target_size:])
