"""Plain-PyTorch point-cloud geometry for the reference: the voxel
downsample's selection order, farthest point sampling, the ball query and
the k nearest neighbours, written from the semantics the system states
(its README and the reference repository's ``models/pointnet2.py``,
``data/preprocessing.py``), one cloud or one batch at a time, with no
kernel, grid or cache. Distances are ``(dx*dx + dy*dy) + dz*dz`` in
float32, each operation rounded on its own.

Imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

VOXEL_PRIMES = (73856093, 19349663, 83492791)
VOXEL_OVERSIZE = 1.2
THIRD_F32 = float(np.float32(1.0 / 3.0))
FPS_INIT_DIST = 1e10


def sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[S, 3] x [N, 3] -> [S, N] squared distances."""
    dx = q[:, None, 0] - r[None, :, 0]
    dy = q[:, None, 1] - r[None, :, 1]
    dz = q[:, None, 2] - r[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def voxel_priority_order(pts: torch.Tensor, u: torch.Tensor,
                         target: int) -> torch.Tensor:
    """Every index of one cloud [N, 3] in selection order: the first
    ``target`` are its voxel downsample.

    The grid: voxel edge cbrt(volume / target) * 1.2 over the cloud's
    bounding box (an extent under 1e-6 counts as 1; the cube root taken in
    float64 of the float32 ratio, rounded to float32). Each occupied
    voxel, keyed by the reference's spatial hash (int32 wraparound), has
    one representative: the point whose index is the float32 mean of its
    members' indices, truncated. Representatives rank by their draw ``u``,
    then every other point by ``1 + u``; ties keep index order."""
    N = pts.shape[0]
    lo = pts.min(dim=0).values
    ext = pts.max(dim=0).values - lo
    ext = torch.where(ext < 1e-6, torch.ones_like(ext), ext)
    ratio = (ext[0] * ext[1]) * ext[2] / target
    edge = torch.pow(ratio.double(), THIRD_F32).float() * VOXEL_OVERSIZE
    edge = torch.where(edge < 1e-6, torch.full_like(edge, 1e-3), edge)
    cell = torch.floor((pts - lo) / edge).to(torch.int32)
    key = ((cell[:, 0] * VOXEL_PRIMES[0]) ^ (cell[:, 1] * VOXEL_PRIMES[1])
           ^ (cell[:, 2] * VOXEL_PRIMES[2]))
    _, group = torch.unique(key, return_inverse=True)
    n_groups = int(group.max()) + 1
    ids = torch.arange(N, device=pts.device)
    members = torch.zeros(n_groups, dtype=torch.int64, device=pts.device)
    members.scatter_add_(0, group, torch.ones_like(ids))
    id_sum = torch.zeros(n_groups, dtype=torch.int64, device=pts.device)
    id_sum.scatter_add_(0, group, ids)
    rep = (id_sum.float() / members.float()).to(torch.int64)
    is_rep = torch.zeros(N, dtype=torch.bool, device=pts.device)
    is_rep[rep] = True
    u = u.float()
    priority = torch.where(is_rep, u, 1.0 + u)
    return torch.sort(priority, stable=True).indices


def farthest_points(xyz: torch.Tensor, npoint: int, start: int
                    ) -> torch.Tensor:
    """FPS of one cloud [N, 3] from index ``start``: each pick is the point
    farthest from those picked (the lowest index among equals)."""
    dist = torch.full((xyz.shape[0],), FPS_INIT_DIST, dtype=torch.float32,
                      device=xyz.device)
    out = torch.empty(npoint, dtype=torch.int64, device=xyz.device)
    cur = torch.tensor(int(start), device=xyz.device)
    for i in range(npoint):
        out[i] = cur
        d = sq_dist(xyz[cur][None], xyz)[0]
        dist = torch.minimum(dist, d)
        cur = torch.argmax(dist)
    return out


def ball_group(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """[S, nsample] indices of one cloud: for each center the ``nsample``
    lowest-index points with squared distance <= float32(radius**2), the
    slots past those found filled with the first found."""
    N = xyz.shape[0]
    r2 = float(np.float32(radius ** 2))
    d = sq_dist(centers, xyz)
    ids = torch.arange(N, device=xyz.device).expand_as(d)
    keys = torch.where(d <= r2, ids, torch.full_like(ids, N))
    top = torch.sort(keys, dim=1).values[:, :nsample]
    return torch.where(top >= N, top[:, :1], top).clamp(max=N - 1)


def nearest(query: torch.Tensor, ref: torch.Tensor, k: int,
            rows: int = 8192, candidates: int = 16
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest refs [M, 3] of each query [Q, 3]: (squared distances
    [Q, k], indices [Q, k]), ascending, in blocks of ``rows`` queries.

    ``candidates`` nearest by the expansion |q|^2 + |r|^2 - 2 q.r (one
    float32 product; its rounding, about 1e-6 for clouds within +-1.8, is
    far below the spacing of the first 16 neighbours of any point of these
    clouds), then their squared distances taken again in the form above and
    sorted."""
    rr = (ref * ref).sum(dim=1)
    c = min(candidates, ref.shape[0])
    dists, idx = [], []
    for s in range(0, query.shape[0], rows):
        q = query[s:s + rows]
        d = torch.addmm(rr[None, :], q, ref.t(), alpha=-2.0)
        d += (q * q).sum(dim=1, keepdim=True)
        i = torch.topk(d, c, dim=1, largest=False, sorted=False).indices
        diff = q[:, None, :] - ref[i]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        d2, order = torch.sort(d2, dim=1, stable=True)
        dists.append(d2[:, :k])
        idx.append(torch.gather(i, 1, order[:, :k]))
    return torch.cat(dists), torch.cat(idx)
