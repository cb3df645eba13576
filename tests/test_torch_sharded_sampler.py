"""The port's ``parallel/sharded_sampler.py`` on gloo process groups
(``torch_dist``).

``guided_sample_loop_sharded`` on {points: 4}, 256 points, 64 coarse
(U = 192 and M = 64 both divide: the coarse denoiser's rows are split
too), 3 steps, against the port's ``guided_sample_loop`` with the same
draws (rank 0 of the group, at the ranks' one thread), at JAX's bars
(``tests/test_sharding.py``: atol 5e-3 and at least 99% of coordinates
within 1e-4): with the brute-force kNN, with the kd-grid at a grid small
enough (2 x 2 x 2) that 64 coarse points engage it, and on the direct path
(bit for bit). Every rank returns the same cloud, bit for bit (measured:
on the CPU at one thread the sharded clouds equal the single-device ones
bit for bit too). Negative control: ``_TEST_SHARD_OFFSET = 1`` (each rank
takes its neighbour's slice) must fail the bars (measured: 2.14 apart, no
coordinate within 1e-4).

``guided_sample_loop_dp`` on {data: 2}, B = 4: each group bit for bit the
port's ``guided_sample_loop`` on that group with its draws (given, or from
the generator of ``group_seed(seed, g)``), and on the direct branch
against JAX's ``guided_sample_loop_dp`` on ``make_mesh({"data": 2})``, its
draws derived from ``fold_in(key, g)``, at the bars of
``tests/test_torch_samplers.py``'s direct-branch parity test (float32:
Chamfer-L2 <= 1e-3, pointwise 5e-2; measured 8.2e-5 and 3.9e-4 at 10
steps); a batch the axis does not divide raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import PointCloudDiffusionModel
from pointcloud_style_transfer_torch.ops import grid_knn
from pointcloud_style_transfer_tpu.models import diffusion as jdiff
from pointcloud_style_transfer_tpu.parallel import make_mesh as jax_mesh
from pointcloud_style_transfer_tpu.parallel.sharded_sampler import \
    guided_sample_loop_dp as jax_dp

from torch_parity import chamfer, models, pin_jax_encoder

ATOL, NEAR, SHARE = 5e-3, 1e-4, 0.99  # tests/test_sharding.py
DP_CHAMFER, DP_ATOL = 1e-3, 5e-2  # tests/test_torch_samplers.py, float32
DP_STEPS, DP_N, DP_B = 10, 256, 4
DP_CFG = dict(total_points=DP_N, global_points=1024, feature_dim=32,
              time_embed_dim=16, use_amp=False)


def within_bars(got, want):
    d = np.abs(got - want)
    return bool((d <= ATOL).all() and (d < NEAR).mean() > SHARE)


def sharded_setup(tmp):
    """Weights, configuration and inputs of the {points: 4} group."""
    torch.manual_seed(1)
    cfg = torch_dist.SAMPLER_CFG
    net = PointCloudDiffusionModel(Config(**cfg), device="cpu").net
    torch.save(net.state_dict(), tmp / "weights.pt")
    (tmp / "sampler_cfg.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(6)
    f32 = np.float32
    steps = torch_dist.SAMPLER_STEPS
    np.savez(tmp / "inputs.npz",
             src=rng.standard_normal((1, 256, 3)).astype(f32),
             cond=rng.standard_normal((1, 256, 3)).astype(f32),
             x_init=rng.standard_normal((1, 256, 3)).astype(f32),
             cond_priority=rng.uniform(size=(1, 256)).astype(f32),
             step_priorities=rng.uniform(size=(steps, 1, 256)).astype(f32),
             fps_starts=np.zeros((2, 1), np.int64))


def dp_setup(tmp):
    """Weights, configuration and inputs of the {data: 2} group; returns
    what JAX's ``guided_sample_loop_dp`` needs."""
    rng = np.random.default_rng(9)
    jmodel, variables, tmodel = models(jax.random.PRNGKey(0), rng, jit=True,
                                       **DP_CFG)
    torch.save(tmodel.net.state_dict(), tmp / "weights.pt")
    (tmp / "sampler_cfg.json").write_text(json.dumps(DP_CFG))
    src = (rng.standard_normal((DP_B, DP_N, 3)) * 0.8).astype(np.float32)
    cond = (rng.standard_normal((DP_B, DP_N, 3)) * 0.8).astype(np.float32)
    k = jax.random.PRNGKey(3)
    b = DP_B // 2
    # guided_sample_loop's initial noise from each group's folded key
    x_init = np.concatenate([np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(k, g), 4)[2], (b, DP_N, 3)))
        for g in range(2)])
    np.savez(tmp / "inputs.npz", src=src, cond=cond, x_init=x_init,
             fps_starts=np.zeros((2, DP_B), np.int64), steps=DP_STEPS)
    return jmodel, variables, src, cond, k


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both groups, run while the parent computes JAX's dp sampler."""
    tmp_sh = tmp_path_factory.mktemp("sharded_sampler")
    tmp_dp = tmp_path_factory.mktemp("dp_sampler")
    sharded_setup(tmp_sh)
    groups = [torch_dist.start_group(torch_dist.sharded_sampler_ranks, 4,
                                     tmp_sh)]
    try:
        jmodel, variables, src, cond, k = dp_setup(tmp_dp)
        groups.append(torch_dist.start_group(torch_dist.dp_sampler_ranks, 2,
                                             tmp_dp))
        mp = pytest.MonkeyPatch()
        try:
            pin_jax_encoder(mp)
            want = np.asarray(jax_dp(
                jmodel, jdiff.make_schedule(jmodel.config), variables,
                jnp.asarray(src), jnp.asarray(cond), k,
                jax_mesh({"data": 2}), num_inference_steps=DP_STEPS,
                guidance_scale=7.5))
        finally:
            mp.undo()
    finally:
        ranks = torch_dist.join_groups(*groups)
    return ranks[0], (ranks[1], want)


@pytest.fixture(scope="module")
def sharded(spawned):
    return spawned[0]


def test_grid_engages_at_the_test_size():
    g = torch_dist.SAMPLER_GRID
    assert grid_knn._grid_engages(64, 3, g["grid_shape"], g["slot_cap"])


@pytest.mark.parametrize("case", ["brute", "grid"])
def test_sharded_matches_single(sharded, case):
    got, want = sharded[0][f"{case}.sharded"], sharded[0][f"{case}.single"]
    assert got.shape == (1, 256, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (np.abs(got - want) < NEAR).mean() > SHARE


def test_sharded_direct_path(sharded):
    got = sharded[0]["direct.sharded"]
    assert got.shape == (1, 64, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, sharded[0]["direct.single"])


@pytest.mark.parametrize("case", ["brute", "grid", "direct", "offset"])
def test_sharded_identical_across_ranks(sharded, case):
    for r in sharded[1:]:
        np.testing.assert_array_equal(r[f"{case}.sharded"],
                                      sharded[0][f"{case}.sharded"])


def test_shard_offset_control_fails(sharded):
    """Each rank interpolating its neighbour's slice must fail the bars
    that the right slices pass."""
    assert not within_bars(sharded[0]["offset.sharded"],
                           sharded[0]["brute.single"])
    assert within_bars(sharded[0]["brute.sharded"],
                       sharded[0]["brute.single"])


@pytest.fixture(scope="module")
def dp(spawned):
    return spawned[1]


@pytest.mark.parametrize("how", ["draws", "seeded"])
def test_dp_groups_equal_single_device(dp, how):
    ranks, _ = dp
    b = DP_B // 2
    for g, r in enumerate(ranks):
        np.testing.assert_array_equal(r[f"dp.{how}"][g * b:(g + 1) * b],
                                      r[f"single.{how}"])
    np.testing.assert_array_equal(ranks[0][f"dp.{how}"],
                                  ranks[1][f"dp.{how}"])


@pytest.mark.parametrize("group", [0, 1])
def test_dp_matches_jax(dp, group):
    ranks, want = dp
    b = DP_B // 2
    got = ranks[0]["dp.draws"][group * b:(group + 1) * b]
    want = want[group * b:(group + 1) * b]
    assert np.isfinite(got).all()
    for i in range(b):
        assert chamfer(got[i:i + 1], want[i:i + 1]) <= DP_CHAMFER
    np.testing.assert_allclose(got, want, rtol=0, atol=DP_ATOL)


def test_dp_ragged_batch_raises(dp):
    ranks, _ = dp
    assert [bool(r["dp.ragged_raises"][0]) for r in ranks] == [True, True]
