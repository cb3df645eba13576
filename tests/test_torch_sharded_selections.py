"""The point-sharded sampler replaying a one-process run's discrete choices
(``guided_sample_loop(..., mesh=, selections=)``), on gloo process groups
of 2 and 4 ranks (``torch_dist``), both started at once.

The guided sampler is chaotic: a near-tie that falls the other way in one
voxel order or one neighbour list moves the whole cloud, and a mesh changes
the summation order of the denoiser's rows. So a sharded run is held to one
process only where it follows that process's choices: the one-process
``guided_sample_loop`` at 256 points, 64 coarse, 3 steps, on the kd-grid
at a grid small enough (2 x 2 x 2) that 64 coarse points engage it
(``test_torch_sharded_sampler.py::test_grid_engages_at_the_test_size``),
records each step's voxel order and upsample neighbours (``selections={}``);
the {points: 2} and {points: 4} meshes replay them with the same draws.

* every rank returns the same cloud, bit for bit;
* the replay lies within Chamfer-L2 1e-3 (the card's ``[reference]`` bar)
  and pointwise 5e-3 (``tests/test_sharding.py``'s atol) of the
  one-process cloud (measured: bit for bit at one thread);
* negative control: each step's recorded neighbours shifted by one query
  row (every unknown point takes another point's neighbours) must fail
  that tolerance.
"""

import functools
import json

import numpy as np
import pytest
import torch

import torch_dist
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (PointCloudDiffusionModel,
                                                    guided_sample_loop,
                                                    make_schedule)
from pointcloud_style_transfer_torch.ops import chamfer_distance_l2
from pointcloud_style_transfer_torch.ops import distance, grid_knn

CHAMFER, ATOL = 1e-3, 5e-3
WORLDS = (2, 4)
CFG = {**torch_dist.SAMPLER_CFG, "knn_backend": "grid"}


def within(got, want) -> bool:
    got, want = torch.from_numpy(got), torch.from_numpy(want)
    return bool(float(chamfer_distance_l2(got, want)[0]) <= CHAMFER
                and (got - want).abs().max() <= ATOL)


def record(tmp, monkeypatch):
    """Weights, draws and the one-process run's cloud and choices."""
    monkeypatch.setattr(grid_knn, "grid_knn_interpolate_layout",
                        functools.partial(
                            grid_knn.grid_knn_interpolate_layout,
                            **torch_dist.SAMPLER_GRID))
    monkeypatch.setattr(distance, "grid_knn", functools.partial(
        grid_knn.grid_knn, **torch_dist.SAMPLER_GRID))
    torch.manual_seed(1)
    cfg = Config(**CFG)
    model = PointCloudDiffusionModel(cfg, device="cpu")
    rng = np.random.default_rng(6)
    f32, steps = np.float32, torch_dist.SAMPLER_STEPS
    x = dict(src=rng.standard_normal((1, 256, 3)).astype(f32),
             cond=rng.standard_normal((1, 256, 3)).astype(f32),
             x_init=rng.standard_normal((1, 256, 3)).astype(f32),
             cond_priority=rng.uniform(size=(1, 256)).astype(f32),
             step_priorities=rng.uniform(size=(steps, 1, 256)).astype(f32),
             fps_starts=np.zeros((2, 1), np.int64))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    selections = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' arithmetic
    try:
        cloud = guided_sample_loop(
            model, make_schedule(cfg), t["src"], t["cond"], steps, 7.5,
            selections=selections, x_init=t["x_init"],
            cond_priority=t["cond_priority"],
            step_priorities=t["step_priorities"],
            fps_starts=t["fps_starts"])
    finally:
        torch.set_num_threads(threads)
    knn_keys = [f"step{s}.knn" for s in range(steps)]
    assert all(k in selections for k in knn_keys)
    shifted = {k: torch.roll(v, 1, dims=1) if k in knn_keys else v
               for k, v in selections.items()}
    for world in WORLDS:
        d = tmp / f"p{world}"
        d.mkdir()
        torch.save(model.net.state_dict(), d / "weights.pt")
        (d / "sampler_cfg.json").write_text(json.dumps(CFG))
        np.savez(d / "inputs.npz", **x)
        torch.save(selections, d / "selections.pt")
        torch.save(shifted, d / "selections_shifted.pt")
    return cloud.numpy()


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_selections")
    with pytest.MonkeyPatch.context() as mp:
        cloud = record(tmp, mp)
    groups = [torch_dist.start_group(torch_dist.selections_ranks, world,
                                     tmp / f"p{world}") for world in WORLDS]
    return cloud, dict(zip(WORLDS, torch_dist.join_groups(*groups)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["selections", "selections_shifted"])
def test_replay_same_on_every_rank(replayed, world, case):
    ranks = replayed[1][world]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case], ranks[0][case])


@pytest.mark.parametrize("world", WORLDS)
def test_replay_matches_one_process(replayed, world):
    cloud, ranks = replayed[0], replayed[1][world]
    got = ranks[0]["selections"]
    assert got.shape == (1, 256, 3) and np.isfinite(got).all()
    assert within(got, cloud)


@pytest.mark.parametrize("world", WORLDS)
def test_shifted_selections_fail(replayed, world):
    """Negative control: the same replay with the neighbours shifted by a
    row misses the tolerance that the recorded ones meet."""
    cloud, ranks = replayed[0], replayed[1][world]
    assert not within(ranks[0]["selections_shifted"], cloud)
