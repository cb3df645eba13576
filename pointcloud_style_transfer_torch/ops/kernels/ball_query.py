"""Ball query: CUDA kernel + plain PyTorch version.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::
_ballquery_kernel`` (wrappers ``_ballquery_single``, ``pallas_ball_query``);
kernel source ``csrc/ball_query.cu``. It is bound by latency on the card: a
few hundred independent scans, and a call lasts as long as its longest one
(a center with fewer than ``nsample`` points inside reads the whole cloud).
One block of warps serves one center and takes the points in ascending
rounds, each warp a contiguous run with all its loads in flight before its
first ballot; a ballot prefix within the warp and an exclusive prefix of
the warps' counts in shared memory append the in-radius indices in
ascending order, and the block stops after the round that fills
``nsample`` slots.

Both versions return [B, S, nsample] int32: the nsample LOWEST indices with
squared distance <= float32(radius**2), ascending, empty slots backfilled
with the row's first index; a row with no point inside stays at the sentinel
N (``index_points`` clamps it).
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import check_points, launch, pairwise_sq_dist

_CHUNK_ELEMS = 1 << 23  # plain version: distance-matrix elements per chunk


def radius_sq_f32(radius: float) -> float:
    """float32(radius**2), the threshold both the TPU kernel and this one
    compare against."""
    return float(np.float32(float(radius) ** 2))


def ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, for CPU tensors and tests."""
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    r2 = radius_sq_f32(radius)
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    ids = torch.arange(N, dtype=torch.int32, device=xyz.device)
    chunk = max(1, _CHUNK_ELEMS // max(N, 1))
    for b in range(B):
        for s in range(0, S, chunk):
            d = pairwise_sq_dist(new_xyz[b, s:s + chunk], xyz[b])
            keys = torch.where(d <= r2, ids, N)
            if N < nsample:  # too few points: the missing slots are empty
                keys = torch.nn.functional.pad(keys, (0, nsample - N), value=N)
            top = torch.topk(keys, nsample, dim=1, largest=False,
                             sorted=True).values
            out[b, s:s + chunk] = torch.where(top >= N, top[:, :1], top)
    return out


def ball_query_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ball_query.cu`` on the current stream."""
    check_points(xyz, "xyz")
    check_points(new_xyz, "new_xyz")
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    if nsample < 1:
        raise ValueError(f"nsample must be positive, got {nsample}")
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    if B * S:
        launch("ball_query", xyz.device, new_xyz.data_ptr(), xyz.data_ptr(),
               out.data_ptr(), B, S, N, nsample, radius_sq_f32(radius))
    return out


def ball_query_kernel(radius: float, nsample: int, xyz: torch.Tensor,
                      new_xyz: torch.Tensor) -> torch.Tensor:
    """Ball query: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    return ball_query_cuda(radius, nsample, xyz, new_xyz)
