"""``model.predict_noise`` alone on the cell's input, [2, rows, 3] (the
conditioned and unconditioned copies of the rows a step denoises: the
voxel downsample, or every point), in milliseconds a call: 10 calls in one
replayed CUDA graph, the median of 5 replays between CUDA events."""

import torch

from h100_bench.core.graph_timing import ms_per_call
from h100_bench.drivers.serve import hierarchical


def read(run):
    model = run.state.get("model")
    cloud = run.state.get("last_out")
    if model is None or cloud is None or run.device.type != "cuda":
        return None
    cfg = run.cell.config
    rows = cfg["global_points"] if hierarchical(run) else cfg["total_points"]
    x = cloud[:1, :rows].expand(2, -1, -1).contiguous()
    t = torch.full((2,), 500, dtype=torch.int64, device=run.device)
    style = torch.zeros((2, cfg["feature_dim"]), device=run.device)
    return ms_per_call(lambda: model.predict_noise(x, t, style))
