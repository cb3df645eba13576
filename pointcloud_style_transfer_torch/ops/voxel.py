"""Voxel-grid downsampling to an exact point count (counterpart of
``pointcloud_style_transfer_tpu/ops/voxel.py``).

Per cloud:

1. voxel size ``cbrt(prod(range) / target) * 1.2``, hash of the voxel
   coordinates with the reference's primes (int32 wraparound);
2. a stable sort by hash gives contiguous voxel segments; each voxel's
   representative is, with ``mode="mean_index"`` (the runtime rule), the
   truncated float32 mean of its point indices (their sum taken exactly,
   then rounded to float32 once: the JAX package's float32 sum is the same
   below 2**24), or with ``mode="center"``
   (the offline rule) its point closest to the voxel's center (a stable
   sort by (hash, distance to the center): the first of each segment);
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


def _voxel_coords(pts: torch.Tensor, xyz_min: torch.Tensor,
                  voxel_size: torch.Tensor) -> torch.Tensor:
    return torch.floor((pts - xyz_min) / voxel_size).to(torch.int32)


def _hash_voxels(vox: torch.Tensor) -> torch.Tensor:
    return ((vox[:, 0] * _PRIMES[0]) ^ (vox[:, 1] * _PRIMES[1])
            ^ (vox[:, 2] * _PRIMES[2]))


def _representatives(pts: torch.Tensor, xyz_min: torch.Tensor,
                     voxel_size: torch.Tensor, mode: str) -> torch.Tensor:
    """Each occupied voxel's representative point id; N stands for none."""
    N = pts.shape[0]
    vox = _voxel_coords(pts, xyz_min, voxel_size)
    h = _hash_voxels(vox)
    if mode == "center":
        center = xyz_min + (vox.float() + 0.5) * voxel_size
        center_dist = ((pts - center) ** 2).sum(dim=-1)
        # lexicographic (hash, distance) as two stable sorts, ties to the
        # lower index
        by_dist = torch.sort(center_dist, stable=True).indices
        hs, o = torch.sort(h[by_dist], stable=True)
        order = by_dist[o]
    elif mode == "mean_index":
        hs, order = torch.sort(h, stable=True)
    else:
        raise ValueError(f"unknown voxel downsample mode: {mode}")
    is_leader = torch.ones(N, dtype=torch.bool, device=pts.device)
    is_leader[1:] = hs[1:] != hs[:-1]
    if mode == "center":  # the first of each segment is nearest its center
        return order[is_leader]
    seg = torch.cumsum(is_leader, dim=0) - 1  # voxel id per sorted position
    # the sums of the point indices exactly, in int64, then in float32 as the
    # JAX package keeps them (the same below 2**24). A float32 index_add_
    # on the card adds in the atomics' order, which changes from run to run
    # and, past 2**24, the rounding and so the representative.
    sums = torch.zeros(N, dtype=torch.int64, device=pts.device)
    sums.index_add_(0, seg, order)
    counts = torch.zeros(N, dtype=torch.int64, device=pts.device)
    counts.index_add_(0, seg, torch.ones_like(order))
    rep = (sums.float() / counts.clamp(min=1).float()).to(torch.int64)
    return torch.where(counts > 0, rep, N)  # N: no voxel, dropped


def _priority_order(pts: torch.Tensor, u: torch.Tensor, target_size: int,
                    geometry: Optional[Tuple[torch.Tensor, torch.Tensor]],
                    mode: str = "mean_index") -> torch.Tensor:
    """All N indices of one cloud [N, 3], ordered by selection priority: the
    first ``target_size`` are the selection, the rest its complement."""
    N = pts.shape[0]
    xyz_min, voxel_size = (voxel_geometry(pts, target_size)
                           if geometry is None else geometry)
    rep_scatter = _representatives(pts, xyz_min, voxel_size, mode)
    rep_mask = torch.zeros(N + 1, dtype=torch.bool, device=pts.device)
    # a scalar written by index: no host tensor to copy (a CUDA graph
    # could not capture that copy)
    rep_mask.index_fill_(0, rep_scatter, True)
    priority = torch.where(rep_mask[:N], u, 1.0 + u)
    return torch.sort(priority, stable=True).indices


def voxel_order(points: torch.Tensor, target_size: int,
                priority: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                geometry: Optional[Geometry] = None,
                mode: str = "mean_index") -> torch.Tensor:
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
                        else (geometry[0][b], geometry[1][b]), mode)
        for b in range(B)])


def voxel_downsample(points: torch.Tensor, target_size: int,
                     priority: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     geometry: Optional[Geometry] = None,
                     mode: str = "mean_index"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Downsample [B, N, 3] to exactly ``target_size`` points.

    Returns (downsampled [B, M, 3], indices [B, M]). ``priority`` [B, N]
    holds the uniform draws (else drawn from ``generator``); ``geometry``
    overrides the per-cloud (xyz_min, voxel_size); ``mode`` is the
    representative rule. N <= target_size returns the cloud with identity
    indices."""
    ds, idx, _ = voxel_downsample_with_complement(
        points, target_size, priority, generator, geometry, mode)
    return ds, idx


def voxel_downsample_with_complement(
        points: torch.Tensor, target_size: int,
        priority: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        geometry: Optional[Geometry] = None, mode: str = "mean_index"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``voxel_downsample`` that also returns the unselected indices:
    (downsampled [B, M, 3], indices [B, M], complement [B, N-M]), the
    complement in priority order (the tail of the same sort). N <=
    target_size returns identity indices and an empty complement."""
    B, N, _ = points.shape
    if N <= target_size:
        idx = torch.arange(N, device=points.device).expand(B, N)
        return (points, idx,
                torch.zeros((B, 0), dtype=torch.int64, device=points.device))
    perm = voxel_order(points, target_size, priority, generator, geometry,
                       mode)
    idx = perm[:, :target_size]
    ds = torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))
    return ds, idx, perm[:, target_size:]


def voxel_downsample_partition(
        points: torch.Tensor, target_size: int,
        priority: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        geometry: Optional[Geometry] = None,
        order: Optional[torch.Tensor] = None, mode: str = "mean_index"
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
    perm = (voxel_order(points, target_size, priority, generator, geometry,
                        mode)
            if order is None else order.to(points.device))
    xyz = torch.gather(points.detach().float(), 1,
                       perm[..., None].expand(-1, -1, 3))
    return (xyz[:, :target_size], perm[:, :target_size],
            perm[:, target_size:], xyz[:, target_size:])
