"""Port diffusion math vs the JAX package: schedules, timesteps, DDIM step.

The schedule tables agree within 1e-6 absolute, except
sqrt(1 - alphas_cumprod): near t=0 it multiplies a difference in
alphas_cumprod by 1/(2 sqrt(1 - ac)) (50x at t=0), and the two packages
round the 1000-term product differently (the port in float64, XLA's
float32 product within 2.8e-7 of exact), so that table is held to the same
1e-6 carried through the square root. The step arithmetic is then tested on
identical tables, within 1e-6 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import diffusion as tdiff
from pointcloud_style_transfer_torch.models.samplers import _step_schedule
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.models import diffusion as jdiff
from pointcloud_style_transfer_tpu.models.samplers import \
    _step_schedule as jax_step_schedule

FIELDS = ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod")


def jax_tables_as_torch(ref) -> tdiff.DiffusionSchedule:
    return tdiff.DiffusionSchedule(**{
        f: torch.from_numpy(np.array(getattr(ref, f))) for f in FIELDS})


@pytest.mark.parametrize("sched", ["cosine", "linear"])
def test_schedule_matches_jax(sched):
    np.testing.assert_array_equal(
        tdiff.make_beta_schedule(sched, 1000, 0.0008),
        jdiff.make_beta_schedule(sched, 1000, 0.0008))
    ours = tdiff.make_schedule(Config(beta_schedule=sched))
    ref = jdiff.make_schedule(JaxConfig(beta_schedule=sched))
    assert ours.num_timesteps == ref.num_timesteps == 1000
    for name in FIELDS[:-1]:
        got = getattr(ours, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    ac = np.asarray(ref.alphas_cumprod, np.float64)
    tol = 1e-6 * np.maximum(1.0, 1.0 / (2.0 * np.sqrt(1.0 - ac)))
    diff = np.abs(ours.sqrt_one_minus_alphas_cumprod.numpy()
                  - np.asarray(ref.sqrt_one_minus_alphas_cumprod))
    assert (diff <= tol).all(), diff.max()


@pytest.mark.parametrize("T,n", [(1000, 50), (1000, 7), (1000, 1000), (10, 3)])
def test_timesteps_and_step_schedule_match_jax(T, n):
    np.testing.assert_array_equal(tdiff.ddim_timesteps(T, n),
                                  jdiff.ddim_timesteps(T, n))
    ts, tp = _step_schedule(T, n)
    jts, jtp = jax_step_schedule(T, n)
    np.testing.assert_array_equal(ts, np.asarray(jts))
    np.testing.assert_array_equal(tp, np.asarray(jtp))
    assert tp[-1] == -1


@pytest.mark.parametrize("t,t_prev,anchor", [
    (999, 979, 0.1), (500, 480, 0.0), (20, 0, 0.1), (0, -1, 0.1),
    (300, -1, 0.0)])
def test_ddim_step_matches_jax(rng, t, t_prev, anchor):
    x = rng.standard_normal((2, 64, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 64, 3)).astype(np.float32)
    src = (rng.standard_normal((2, 64, 3)) * 0.8).astype(np.float32)
    ref_sched = jdiff.make_schedule(JaxConfig())
    ours = tdiff.ddim_step(
        jax_tables_as_torch(ref_sched), torch.from_numpy(x),
        torch.from_numpy(eps), t, t_prev, source_points=torch.from_numpy(src),
        content_anchor=anchor, target_range=1.8)
    ref = jdiff.ddim_step(
        ref_sched, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t),
        jnp.asarray(t_prev), source_points=jnp.asarray(src),
        content_anchor=anchor, target_range=1.8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_q_sample_and_constraint_match_jax(rng):
    x0 = rng.standard_normal((2, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 64, 3)).astype(np.float32)
    t = np.array([17, 905])
    ref_sched = jdiff.make_schedule(JaxConfig())
    ours = tdiff.q_sample(jax_tables_as_torch(ref_sched), torch.from_numpy(x0),
                          torch.from_numpy(t), torch.from_numpy(noise))
    ref = jdiff.q_sample(ref_sched, jnp.asarray(x0), jnp.asarray(t),
                         jnp.asarray(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    p = (x0 * 3).astype(np.float32)
    np.testing.assert_allclose(
        tdiff.geometric_constraint(torch.from_numpy(p), 1.8).numpy(),
        np.asarray(jdiff.geometric_constraint(jnp.asarray(p), 1.8)),
        rtol=0, atol=1e-6)
