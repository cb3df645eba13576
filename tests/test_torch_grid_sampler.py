"""The sampler's upsample through the kd-grid: the port vs the JAX package
with ``knn_backend="grid"`` (the JAX package's CPU default ``"auto"``
resolves to its jnp kNN), converted weights and the same draws. Both
packages' ``grid_knn_interpolate_layout`` get a small grid (2, 2, 2) with
slot_cap 256 and tq 64, under which 256 coarse points engage the production
shape of the grid: whole columns, y-run slots, brute-force patches for the
rows it cannot prove exact. The JAX kernels run in interpret mode.

* one step from the same x_t: noise field within 1e-5 (the bar of the brute
  path's one-step test);
* 50 hierarchical steps, float32: Chamfer-L2 <= max(1e-3, 2x the distance
  between two JAX runs whose initial noise differs by one ulp), as the
  brute path's 50-step test holds it.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointcloud_style_transfer_torch.models import (guided_sample_loop,
                                                    make_schedule)
from pointcloud_style_transfer_torch.models import samplers as tsamp
from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_torch.ops import voxel_downsample_partition
from pointcloud_style_transfer_tpu.models import diffusion as jdiff
from pointcloud_style_transfer_tpu.models import samplers as jsamp
from pointcloud_style_transfer_tpu.ops import voxel as jvox

from torch_parity import chamfer, models, pin_jax_encoder, sampler_draws

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

STEPS, SCALE = 50, 7.5
N, M = 1024, 256
CFG = dict(total_points=N, global_points=M, feature_dim=32, time_embed_dim=16,
           use_amp=False, knn_backend="grid")
GRID = dict(grid_shape=(2, 2, 2), tq=64, slot_cap=256)


def small_grids(monkeypatch):
    monkeypatch.setattr(J, "grid_knn_interpolate_layout", functools.partial(
        J.grid_knn_interpolate_layout, interpret=True, **GRID))
    monkeypatch.setattr(P, "grid_knn_interpolate_layout", functools.partial(
        P.grid_knn_interpolate_layout, **GRID))
    sl = P._layout_slots(P._build_struct(torch.randn(M, 3), GRID["grid_shape"]),
                         torch.randn(N - M, 3), GRID["grid_shape"], GRID["tq"],
                         GRID["slot_cap"])
    assert sl.full_z and sl.st.shape[1] == 3  # y-run slots


def test_upsample_unknown_grid_one_step(rng, key, monkeypatch):
    small_grids(monkeypatch)
    jmodel, variables, tmodel = models(key, rng, **CFG)
    x = rng.standard_normal((1, N, 3)).astype(np.float32)
    x[0, :40] = x[0, 40:80]  # exact duplicates
    style = rng.standard_normal((1, 32)).astype(np.float32)
    style_in = np.concatenate([style, np.zeros_like(style)])
    t = 500

    k = jax.random.PRNGKey(5)
    sel, idx, comp, cxyz = jvox.voxel_downsample_partition(jnp.asarray(x), M, k)
    pred = jmodel.predict_noise(variables, jnp.concatenate([sel, sel]),
                                jnp.full((2,), t, jnp.int32),
                                jnp.asarray(style_in))
    nc, nu = jnp.split(pred.astype(jnp.float32), 2)
    noise_j = jsamp._upsample_unknown(jnp.asarray(x), idx, nu + SCALE * (nc - nu),
                                      "grid", unknown=comp, ref_xyz=sel,
                                      unknown_xyz=cxyz)

    u = np.array(jax.random.uniform(jax.random.split(k, 1)[0], (N,)))[None]
    mn, size = jvox._voxel_geometry(jnp.asarray(x[0]), M)
    geom = (torch.from_numpy(np.array(mn))[None],
            torch.from_numpy(np.array(size))[None])
    t_sel, t_idx, t_comp, t_cxyz = voxel_downsample_partition(
        torch.from_numpy(x), M, priority=torch.from_numpy(u), geometry=geom)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    pred_t = tmodel.predict_noise(torch.cat([t_sel, t_sel]),
                                  torch.full((2,), t),
                                  torch.from_numpy(style_in)).float()
    tc, tu = pred_t.chunk(2)
    passes = len(P.UNSAFE_COUNTS)
    noise_t = tsamp._upsample_unknown(torch.from_numpy(x), t_idx,
                                      tu + SCALE * (tc - tu),
                                      tsamp.resolve_sampler_knn_backend(
                                          tmodel.config),
                                      unknown=t_comp, ref_xyz=t_sel,
                                      unknown_xyz=t_cxyz)
    assert len(P.UNSAFE_COUNTS) == passes + 1  # the grid ran
    np.testing.assert_allclose(noise_t.numpy(), np.asarray(noise_j),
                               rtol=1e-5, atol=1e-5)


def test_hierarchical_50_steps_grid_float32(rng, key, monkeypatch):
    pin_jax_encoder(monkeypatch)
    small_grids(monkeypatch)
    jmodel, variables, tmodel = models(key, rng, **CFG)
    src = (rng.standard_normal((1, N, 3)) * 0.8).astype(np.float32)
    cond = (rng.standard_normal((1, N, 3)) * 0.8).astype(np.float32)
    x0 = rng.standard_normal((1, N, 3)).astype(np.float32)

    def jax_run(x_init):
        return np.asarray(jsamp.guided_sample_loop(
            jmodel, jdiff.make_schedule(jmodel.config), variables,
            jnp.asarray(src), jnp.asarray(cond), key,
            num_inference_steps=STEPS, guidance_scale=SCALE,
            x_init=jnp.asarray(x_init)))
    want = jax_run(x0)
    self_gap = chamfer(jax_run((x0 * np.float32(1 + 2**-23))), want)
    cond_u, step_u = sampler_draws(key, STEPS, N, N, M)
    passes = len(P.UNSAFE_COUNTS)
    got = guided_sample_loop(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(src),
        torch.from_numpy(cond), num_inference_steps=STEPS,
        guidance_scale=SCALE, x_init=torch.from_numpy(x0),
        cond_priority=torch.from_numpy(cond_u),
        step_priorities=torch.from_numpy(step_u),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64)).numpy()
    assert len(P.UNSAFE_COUNTS) == passes + STEPS  # one grid pass a step
    assert np.isfinite(got).all() and got.shape == (1, N, 3)
    assert chamfer(got, want) <= max(1e-3, 2 * self_gap), self_gap
