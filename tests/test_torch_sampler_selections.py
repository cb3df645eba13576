"""The guided sampler's injectable selections (``guided_sample_loop(...,
selections=...)``): each step's voxel order and the upsample's neighbours,
recorded into a dict and replayed from it, so that a run on the card can
follow the CPU's choices at near-ties (``chip_smoke.py``'s ``[reference]``).

Recording changes no output, on the brute-force path and on the kd-grid
(a small grid that 256 coarse points engage); a recorded run replayed gives
the same output bit for bit; a planted neighbour changes exactly the point
it is planted for; ``voxel_order`` is the order the downsample takes.
"""

import functools

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (
    DiffusionNet, PointCloudDiffusionModel, guided_sample_loop, make_schedule)
from pointcloud_style_transfer_torch.ops import distance
from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_torch.ops import (voxel_downsample,
                                                 voxel_downsample_partition)
from pointcloud_style_transfer_torch.ops.voxel import voxel_order

STEPS, N, M = 5, 1024, 256
GRID = dict(grid_shape=(2, 2, 2), tq=64, slot_cap=256)


def small_grid(monkeypatch):
    """The grid's interpolation and kNN at a grid that 256 refs engage."""
    monkeypatch.setattr(P, "grid_knn_interpolate_layout", functools.partial(
        P.grid_knn_interpolate_layout, **GRID))
    monkeypatch.setattr(distance, "grid_knn",
                        functools.partial(P.grid_knn, **GRID))


def sample(rng_seed: int, backend: str, selections=None):
    """A small float32 model's 5-step run with numpy-seeded draws."""
    rng = np.random.default_rng(rng_seed)
    cfg = Config(total_points=N, global_points=M, feature_dim=32,
                 time_embed_dim=16, use_amp=False, knn_backend=backend)
    torch.manual_seed(3)
    net = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    model = PointCloudDiffusionModel(cfg, "cpu", net=net)
    src = torch.from_numpy(rng.standard_normal((1, N, 3), np.float32))
    cond = torch.from_numpy(rng.standard_normal((1, N, 3), np.float32))
    draws = dict(
        x_init=torch.from_numpy(rng.standard_normal((1, N, 3), np.float32)),
        cond_priority=torch.from_numpy(rng.random((1, N), np.float32)),
        step_priorities=torch.from_numpy(rng.random((STEPS, 1, N),
                                                    np.float32)),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64))
    kw = {} if selections is None else dict(selections=selections)
    return guided_sample_loop(model, make_schedule(cfg), src, cond,
                              num_inference_steps=STEPS, guidance_scale=7.5,
                              **draws, **kw)


@pytest.mark.parametrize("backend", ["pallas", "grid"])
def test_recording_changes_nothing_and_replay_repeats(monkeypatch, backend):
    if backend == "grid":
        small_grid(monkeypatch)
    plain = sample(0, backend)
    sel = {}
    assert torch.equal(sample(0, backend, sel), plain)
    for s in range(STEPS):
        order, nbr = sel[f"step{s}.voxel"], sel[f"step{s}.knn"]
        assert order.shape == (1, N) and nbr.shape == (1, N - M, 3)
        assert torch.equal(torch.sort(order[0]).values, torch.arange(N))
        for key in (f"step{s}.voxel.points", f"step{s}.knn.query",
                    f"step{s}.knn.ref"):
            assert key in sel
    replay = {k: v for k, v in sel.items() if k.endswith((".voxel", ".knn"))}
    assert torch.equal(sample(0, backend, replay), plain)
    # the replaying run keeps the points it took each choice on
    assert torch.equal(replay["step2.knn.query"], sel["step2.knn.query"])


def test_grid_records_the_exact_neighbours(monkeypatch):
    """The grid's recorded neighbours are the exact kNN's wherever the
    k + 1 nearest distances are distinct."""
    small_grid(monkeypatch)
    sel = {}
    sample(1, "grid", sel)
    for s in range(STEPS):
        q, r = sel[f"step{s}.knn.query"], sel[f"step{s}.knn.ref"]
        d4, i4 = distance.knn(q, r, 4, backend="pallas")
        distinct = (d4[..., 1:] != d4[..., :-1]).all(-1)
        got = torch.sort(sel[f"step{s}.knn"], dim=-1).values
        want = torch.sort(i4[..., :3], dim=-1).values
        assert torch.equal(got[distinct], want[distinct])


def test_a_planted_neighbour_moves_only_its_point():
    """Replaying the run with one row of the last step's neighbours changed
    changes the output at that row's point and nowhere else."""
    sel = {}
    plain = sample(2, "pallas", sel)
    replay = {k: v.clone() for k, v in sel.items()
              if k.endswith((".voxel", ".knn"))}
    last = STEPS - 1
    row = 17
    replay[f"step{last}.knn"][0, row] = torch.tensor([0, 1, 2])
    assert not torch.equal(replay[f"step{last}.knn"][0, row],
                           sel[f"step{last}.knn"][0, row])
    out = sample(2, "pallas", replay)
    point = int(sel[f"step{last}.voxel"][0, M + row])
    moved = (out != plain).any(-1)[0]
    assert moved[point] and int(moved.sum()) == 1


def test_voxel_order_is_the_downsample_order(rng):
    x = torch.from_numpy(rng.standard_normal((2, 900, 3), np.float32))
    u = torch.from_numpy(rng.random((2, 900), np.float32))
    order = voxel_order(x, 200, priority=u)
    for got, want in zip(voxel_downsample_partition(x, 200, order=order),
                         voxel_downsample_partition(x, 200, priority=u)):
        assert torch.equal(got, want)
    assert torch.equal(voxel_downsample(x, 200, priority=u)[1],
                       order[:, :200])
