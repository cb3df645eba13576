"""Farthest point sampling: CUDA kernel + plain PyTorch version.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/fps.py::_fps_kernel``
(wrappers ``_fps_single``, ``pallas_farthest_point_sample``); kernel source
``csrc/fps.cu``. It is latency-bound on the card: ``npoint`` dependent
iterations, each a pass over the cloud and a block-wide argmax. One block per
cloud keeps each thread's slice of the running distances in registers and
re-reads the coordinates from L2.

Both versions take the start index per cloud from the caller, store the
current index before updating the distances (initialised to 1e10), and pick
as next the lowest index reaching the maximum distance. They return
[B, npoint] int32.
"""

from __future__ import annotations

import torch

from ._common import check_points, launch

MAX_POINTS = 64 * 1024  # the kernel keeps at most 64 distances per thread
_INIT_DIST = 1e10


def fps_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor
              ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, for CPU tensors and tests."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    dist = torch.full((B, N), _INIT_DIST, dtype=torch.float32, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    bidx = torch.arange(B, device=xyz.device)
    farthest = start.to(device=xyz.device, dtype=torch.int64)
    for i in range(npoint):
        out[:, i] = farthest
        c = xyz[bidx, farthest]  # [B, 3]
        dx = xyz[..., 0] - c[:, 0:1]
        dy = xyz[..., 1] - c[:, 1:2]
        dz = xyz[..., 2] - c[:, 2:3]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        farthest = torch.argmax(dist, dim=1)  # first index of the maximum
    return out


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor
             ) -> torch.Tensor:
    """Launch ``csrc/fps.cu`` on the current stream. ``start`` is an int32
    [B] tensor on the same device, each entry in [0, N)."""
    check_points(xyz, "xyz")
    B, N, _ = xyz.shape
    if not 0 < N <= MAX_POINTS:
        raise ValueError(f"the FPS kernel takes 1..{MAX_POINTS} points, got {N}")
    if (start.device != xyz.device or start.dtype != torch.int32
            or start.shape != (B,) or not start.is_contiguous()):
        raise ValueError("start must be a contiguous int32 [B] tensor on the "
                         "points' device")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B and npoint:
        launch("fps", xyz.device, xyz.data_ptr(), start.data_ptr(),
               out.data_ptr(), B, N, npoint)
    return out


def farthest_point_sample_kernel(xyz: torch.Tensor, npoint: int,
                                 start: torch.Tensor) -> torch.Tensor:
    """FPS: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, start)
    return fps_cuda(xyz, npoint, start)
