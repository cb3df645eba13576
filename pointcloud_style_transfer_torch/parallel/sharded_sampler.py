"""Point-sharded and data-parallel CFG samplers (counterpart of
``pointcloud_style_transfer_tpu/parallel/sharded_sampler.py``).

``guided_sample_loop_sharded`` cuts the latency of one cloud over the
``points`` ranks. Every rank does the coarse work of a step with the same
draws, so it is the same on every rank with no communication: the voxel
partition, the style encoder (once), the CFG combine and the DDIM update.
Each rank then takes the kNN + interpolation of its U/n slice of the
U = N - M unknown points against the coarse points with the configured
backend (the kd-grid's interpolation kernel by default,
``resolve_sampler_knn_backend``), and the slices are put back together with
``all_gather_into_tensor``. When n divides M the coarse denoiser's rows are
split over the ranks and all-gathered too. It is ``guided_sample_loop``
itself, given the mesh: ``RowSplit`` holds this rank's share. Every rank
returns the same cloud, bit for bit; on one rank it is the single-device
run's, bit for bit.

``guided_sample_loop_dp`` raises throughput instead: the clouds are split
over the ``data`` ranks and group g is sampled as ``guided_sample_loop``
samples it on one device with its own draws (the counterpart of JAX's
``fold_in(key, g)``), with no communication until the result is gathered.

Neither is called by an entry point of the port (nor of the JAX package).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models import guided_sample_loop
from ..models.diffusion import DiffusionSchedule
from ..models.model import PointCloudDiffusionModel
from .mesh import (DATA_AXIS, POINTS_AXIS, all_gather, axis_group,
                   axis_rank, axis_size, check_backend)

# Test-only fault injection: a test sets it to 1 to prove that its
# sharded-vs-single-device assertions catch a rank taking its neighbour's
# slice. Not a parameter, so that no caller can pass it.
_TEST_SHARD_OFFSET = 0


class RowSplit:
    """This rank's share of rows over the ranks of ``axis_name``: the
    me-th of n contiguous slices along dim 1, and their all-gather."""

    def __init__(self, mesh, axis_name: str, device_type: str):
        self.group = axis_group(mesh, axis_name)
        check_backend(device_type, self.group)
        self.n = axis_size(mesh, axis_name)
        self.me = (axis_rank(mesh, axis_name) + _TEST_SHARD_OFFSET) % self.n
        self.axis_name = axis_name

    def check(self, rows: int, what: str) -> None:
        if rows % self.n:
            raise ValueError(f"{what}={rows} not divisible by the "
                             f"{self.axis_name} axis ({self.n})")

    def local(self, x: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return x
        m = x.shape[1] // self.n
        return x[:, self.me * m:(self.me + 1) * m]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.n == 1 else all_gather(x, self.group, 1)


def guided_sample_loop_sharded(model: PointCloudDiffusionModel,
                               schedule: DiffusionSchedule,
                               source_points: torch.Tensor,
                               condition_points: torch.Tensor,
                               mesh,
                               num_inference_steps: int = 50,
                               guidance_scale: float = 7.5,
                               axis_name: str = POINTS_AXIS,
                               knn_backend: Optional[str] = None,
                               **draws) -> torch.Tensor:
    """``guided_sample_loop`` with the upsample's kNN split over the ranks
    of ``axis_name``. Every rank passes the same [B, N, 3] source and
    condition clouds and the same draws (``x_init``, ``cond_priority``,
    ``step_priorities``, ``fps_starts``, as ``guided_sample_loop`` takes
    them) or an identically seeded ``generator``; each returns the same
    [B, N, 3]. The unknown count N - M must divide by the axis size."""
    return guided_sample_loop(
        model, schedule, source_points, condition_points,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, knn_backend=knn_backend, mesh=mesh,
        axis_name=axis_name, **draws)


def group_seed(seed: int, group: int) -> int:
    """The seed of cloud group ``group``'s generator: a well-mixed function
    of (seed, group), the same for every rank and device count."""
    return int(np.random.SeedSequence([seed, group]).generate_state(1)[0])


@torch.no_grad()
def guided_sample_loop_dp(model: PointCloudDiffusionModel,
                          schedule: DiffusionSchedule,
                          source_points: torch.Tensor,
                          condition_points: torch.Tensor,
                          mesh,
                          num_inference_steps: int = 50,
                          guidance_scale: float = 7.5,
                          axis_name: str = DATA_AXIS,
                          draws: Optional[Sequence[dict]] = None,
                          seed: int = 0) -> torch.Tensor:
    """Data-parallel sampling of a [B, N, 3] batch that every rank holds:
    the g-th contiguous B/d slice of clouds is sampled by the ranks at
    coordinate g of ``axis_name`` exactly as ``guided_sample_loop`` samples
    it on one device, with ``draws[g]`` (its keyword draws: ``x_init``,
    ``cond_priority``, ``step_priorities``, ``fps_starts``) or, without
    ``draws``, a generator seeded with ``group_seed(seed, g)``. Every rank
    returns the whole [B, N, 3] result."""
    B = source_points.shape[0]
    n = axis_size(mesh, axis_name)
    if B % n:
        raise ValueError(f"batch {B} not divisible by the {axis_name} axis "
                         f"({n})")
    group = axis_group(mesh, axis_name)
    check_backend(model.device.type, group)
    g = axis_rank(mesh, axis_name)
    b = B // n
    kw = dict(draws[g]) if draws is not None else {
        "generator": torch.Generator(device=model.device).manual_seed(
            group_seed(seed, g))}
    out = guided_sample_loop(
        model, schedule, source_points[g * b:(g + 1) * b],
        condition_points[g * b:(g + 1) * b],
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, **kw)
    return all_gather(out, group, 0)
