"""The kd-grid's k = 3 interpolation of the unknown points (N - M) from the
coarse ones (M) alone, as ``models/samplers.py::_upsample_unknown`` calls
it (``grid_knn_interpolate_layout``), on the voxel partition of the cell's
last answer, in milliseconds a call: 10 calls in one replayed CUDA graph,
the median of 5 replays between CUDA events."""

import torch

from h100_bench.core.graph_timing import ms_per_call
from h100_bench.drivers.serve import hierarchical


def read(run):
    cloud = run.state.get("last_out")
    if cloud is None or not hierarchical(run) or run.device.type != "cuda":
        return None
    from pointcloud_style_transfer_torch.ops import grid_knn
    from pointcloud_style_transfer_torch.ops.voxel import (
        voxel_downsample_partition)
    M = run.cell.config["global_points"]
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    u = torch.rand(cloud.shape[:2], generator=gen, device=run.device)
    coarse, _, _, unknown = voxel_downsample_partition(cloud[:1], M,
                                                       priority=u[:1])
    values = torch.randn((M, 3), generator=gen, device=run.device)
    return ms_per_call(lambda: grid_knn.grid_knn_interpolate_layout(
        unknown[0], coarse[0], values, 3))
