"""Farthest point sampling: CUDA kernel + plain PyTorch version.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/fps.py::_fps_kernel``
(wrappers ``_fps_single``, ``pallas_farthest_point_sample``); kernel source
``csrc/fps.cu``. It is latency-bound on the card: ``npoint`` dependent
iterations, each an update of every point's distance and an argmax over the
cloud. As the TPU kept the cloud in VMEM, the kernel keeps it in the
registers of a thread-block cluster (``fps_plan``: S blocks, PER points per
thread), loaded once; each iteration's argmax crosses the cluster through
distributed shared memory behind one cluster barrier. A cloud above
``MAX_POINTS`` does not fit those registers: its plan has PER = 0
(``STREAM``), a kernel of the same source that keeps the running distances
in a global scratch [B, N] (L2-resident) and re-reads the coordinates every
iteration, with the same slices and reductions, so any N >= 1 is taken.

Both versions take the start index per cloud from the caller, store the
current index before updating the distances (initialised to 1e10), and pick
as next the lowest index reaching the maximum distance. They return
[B, npoint] int32.
"""

from __future__ import annotations

import torch

from ._common import check_points, launch

CLUSTER_SIZES = (1, 2, 4, 8)  # ranks per cluster (the portable sizes)
PERS = (1, 2, 4, 8)           # points per thread the kernel is built for
STREAM = 0  # PER of the streaming kernel: distances in scratch, any N
MAX_THREADS = 1024
# the largest cloud a cluster's registers hold: 64 * 1024
MAX_POINTS = CLUSTER_SIZES[-1] * MAX_THREADS * PERS[-1]
_RANK_POINTS = 4096  # a rank's points beyond which the cluster grows
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


def fps_plan(n: int) -> tuple[int, int, int]:
    """The launch ``(S, threads, PER)`` for clouds of n points, chosen from
    ``tools/sweep_kernel_plans.py`` on an H100 (PERF.md, PR 5): one block while
    1,024 threads hold the cloud (a cluster barrier costs more than a fuller
    block), else the smallest cluster whose ranks hold at most
    ``_RANK_POINTS`` points each; then half as many threads as points, up to
    512 (1,024 where 512 cannot hold the slice), and the fewest points per
    thread that hold it. Above ``MAX_POINTS``: the streaming kernel on the
    largest cluster, (8, 1024, ``STREAM``)."""
    if n > MAX_POINTS:
        return CLUSTER_SIZES[-1], MAX_THREADS, STREAM
    if n <= MAX_THREADS * PERS[-1]:
        S = 1
    else:
        S = next((s for s in CLUSTER_SIZES if -(-n // s) <= _RANK_POINTS),
                 CLUSTER_SIZES[-1])
    per_rank = -(-n // S)
    threads = 32
    while threads < min(512, -(-per_rank // 2)):
        threads *= 2
    if threads * PERS[-1] < per_rank:
        threads = MAX_THREADS
    per = next(p for p in PERS if threads * p >= per_rank)
    return S, threads, per


def _check_plan(plan: tuple[int, int, int], n: int) -> None:
    S, threads, per = plan
    if (S not in CLUSTER_SIZES or per not in PERS + (STREAM,)
            or not 32 <= threads <= MAX_THREADS or threads & (threads - 1)
            or (per != STREAM and threads * per < -(-n // S))):
        raise ValueError(f"bad FPS launch plan {plan} for {n} points")


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
             plan: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Launch ``csrc/fps.cu`` on the current stream, with ``fps_plan``'s
    launch unless ``plan`` (S, threads, PER) is given. ``start`` is an int32
    [B] tensor on the same device, each entry in [0, N)."""
    check_points(xyz, "xyz")
    B, N, _ = xyz.shape
    if N == 0:
        raise ValueError("the FPS kernel needs at least one point")
    if (start.device != xyz.device or start.dtype != torch.int32
            or start.shape != (B,) or not start.is_contiguous()):
        raise ValueError("start must be a contiguous int32 [B] tensor on the "
                         "points' device")
    plan = fps_plan(N) if plan is None else tuple(plan)
    _check_plan(plan, N)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B and npoint:
        scratch = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
                   if plan[2] == STREAM else None)
        launch("fps", xyz.device, xyz.data_ptr(), start.data_ptr(),
               out.data_ptr(), None if scratch is None else scratch.data_ptr(),
               B, N, npoint, *plan)
    return out


def farthest_point_sample_kernel(xyz: torch.Tensor, npoint: int,
                                 start: torch.Tensor) -> torch.Tensor:
    """FPS: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, start)
    return fps_cuda(xyz, npoint, start)
