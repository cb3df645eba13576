"""The coarse displacement-field sampler and the plain DDIM loop: the port
vs the JAX package with converted weights and the same draws (voxel
priorities and initial noise drawn in JAX and passed across; FPS starts
pinned to 0; the JAX kNN kernels in interpret mode).

* ``guided_sample_loop_coarse``, float32, 50 steps: the trajectory has no
  per-step voxelisation, so the direct branch's bars hold: eval Chamfer-L2
  <= 1e-3 and 5e-2 pointwise, with and without the hierarchy (N <= M).
* ``ddim_sample_loop``: one step of its body from the same x_t gives the
  same voxel selection and the noise within 1e-5; over 50 steps the per-step voxel selection is
  discontinuous in x (see ``test_torch_samplers.py``), so the port is held
  to Chamfer-L2 <= max(1e-3, 2x the distance between two JAX runs whose
  condition cloud differs by one ulp).
* one hierarchical guided step with ``knn_backend`` "pallas_f32packed" and
  "pallas_pruned": noise within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.models import (ddim_sample_loop,
                                                    guided_sample_loop_coarse,
                                                    make_schedule)
from pointcloud_style_transfer_torch.models import samplers as tsamp
from pointcloud_style_transfer_torch.ops import voxel_downsample_partition
from pointcloud_style_transfer_tpu.models import diffusion as jdiff
from pointcloud_style_transfer_tpu.models import samplers as jsamp
from pointcloud_style_transfer_tpu.ops import voxel as jvox
from pointcloud_style_transfer_tpu.ops.pallas import distance_topk, pruned_knn

from torch_parity import chamfer, models, pin_jax_encoder

STEPS, SCALE = 50, 7.5
HIER = dict(total_points=512, global_points=128, feature_dim=32,
            time_embed_dim=16, use_amp=False, knn_backend="pallas")
FPS0 = torch.zeros((2, 1), dtype=torch.int64)


@pytest.fixture
def interpret_jax_kernels(monkeypatch):
    for mod, name in ((distance_topk, "pallas_knn"),
                      (distance_topk, "pallas_knn_f32packed"),
                      (pruned_knn, "pallas_knn_pruned")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))


def uniform(k, size):
    """One cloud's voxel priorities as ``voxel_downsample`` draws them."""
    return np.array(jax.random.uniform(jax.random.split(k, 1)[0], (size,)))[None]


def clouds(rng, n):
    return ((rng.standard_normal((1, n, 3)) * 0.8).astype(np.float32),
            (rng.standard_normal((1, n, 3)) * 0.8).astype(np.float32))


@pytest.mark.parametrize("n", [512, 100])  # hierarchical; N <= M
def test_coarse_sampler_50_steps_float32(rng, key, monkeypatch,
                                         interpret_jax_kernels, n):
    pin_jax_encoder(monkeypatch)
    m = HIER["global_points"]
    jmodel, variables, tmodel = models(key, rng, **HIER)
    src, cond = clouds(rng, n)
    want = np.asarray(jsamp.guided_sample_loop_coarse(
        jmodel, jdiff.make_schedule(jmodel.config), variables,
        jnp.asarray(src), jnp.asarray(cond), key, num_inference_steps=STEPS,
        guidance_scale=SCALE))
    k_cond, _, k_src, k_init, _ = jax.random.split(key, 5)
    hier = n > m
    x0 = np.array(jax.random.normal(k_init, (1, m if hier else n, 3)))
    got = guided_sample_loop_coarse(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(src),
        torch.from_numpy(cond), num_inference_steps=STEPS,
        guidance_scale=SCALE, x_init=torch.from_numpy(x0),
        cond_priority=torch.from_numpy(uniform(k_cond, n)) if hier else None,
        src_priority=torch.from_numpy(uniform(k_src, n)) if hier else None,
        fps_starts=FPS0).numpy()
    assert np.isfinite(got).all() and got.shape == (1, n, 3)
    assert chamfer(got, want) <= 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_coarse_sampler_without_hierarchy_is_full_resolution(rng, key):
    """``use_hierarchical=False`` keeps every point in the loop: the output
    is the guided loop's direct branch from the same draws."""
    _, _, tmodel = models(key, rng, **HIER)
    src, cond = clouds(rng, 300)
    x0 = torch.from_numpy(rng.standard_normal((1, 300, 3)).astype(np.float32))
    u = torch.from_numpy(rng.random((1, 300)).astype(np.float32))
    kw = dict(num_inference_steps=4, x_init=x0, cond_priority=u,
              fps_starts=FPS0)
    got = guided_sample_loop_coarse(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(src),
        torch.from_numpy(cond), use_hierarchical=False, **kw)
    want = tsamp.guided_sample_loop(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(src),
        torch.from_numpy(cond), use_hierarchical=False, **kw)
    assert torch.equal(got, want)


def ddim_draws(key, steps, n_cond, n, m):
    """What JAX's ``ddim_sample_loop`` draws from ``key``: the initial noise
    and each step's condition and state voxel priorities."""
    k_init, k_steps = jax.random.split(key)
    x0 = np.array(jax.random.normal(k_init, (1, n, 3)))
    cond_u, step_u = [], []
    for k in jax.random.split(k_steps, steps):
        k_fwd, _ = jax.random.split(k)
        k_vox_c, _, _, k_vox_x, _ = jax.random.split(k_fwd, 5)
        cond_u.append(uniform(k_vox_c, n_cond))
        step_u.append(uniform(k_vox_x, n))
    return (x0, np.stack(cond_u) if n_cond > m else None,
            np.stack(step_u) if n > m else None)


def run_ddim(key, rng, monkeypatch, steps, perturb_jax_again=False):
    pin_jax_encoder(monkeypatch)
    n, m = 512, HIER["global_points"]
    jmodel, variables, tmodel = models(key, rng, **HIER)
    _, cond = clouds(rng, n)
    shape_like = np.zeros((1, n, 3), np.float32)

    def jax_run(c):
        return np.asarray(jsamp.ddim_sample_loop(
            jmodel, jdiff.make_schedule(jmodel.config), variables,
            jnp.asarray(shape_like), jnp.asarray(c), key,
            num_inference_steps=steps))
    want = jax_run(cond)
    gap = chamfer(jax_run(cond * np.float32(1 + 2 ** -23)), want) \
        if perturb_jax_again else None
    x0, cond_u, step_u = ddim_draws(key, steps, n, n, m)
    got = ddim_sample_loop(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(shape_like),
        torch.from_numpy(cond), num_inference_steps=steps,
        x_init=torch.from_numpy(x0),
        cond_priorities=torch.from_numpy(cond_u),
        step_priorities=torch.from_numpy(step_u), fps_starts=FPS0).numpy()
    assert np.isfinite(got).all() and got.shape == (1, n, 3)
    return got, want, gap


def test_ddim_one_step_float32(rng, key, monkeypatch, interpret_jax_kernels):
    """The loop's body at t = 500 from the same x_t (the loop's first step
    sits at t = 999, where 1/sqrt(alpha_t) amplifies rounding beyond any
    bar): identical voxel indices, noise and next state within 1e-5."""
    pin_jax_encoder(monkeypatch)
    n, m, t, tp = 512, HIER["global_points"], 500, 480
    jmodel, variables, tmodel = models(key, rng, **HIER)
    x, cond = clouds(rng, n)
    k_fwd = jax.random.PRNGKey(7)
    pred, idx, _ = jmodel.forward(variables, jnp.asarray(x),
                                  jnp.full((1,), t, jnp.int32),
                                  jnp.asarray(cond), key=k_fwd,
                                  cond_drop_prob=0.0, use_hierarchical=True,
                                  train=False, mutable=False)
    noise_j = jsamp._upsample_unknown(jnp.asarray(x), idx,
                                      pred.astype(jnp.float32), "pallas")
    x_next_j = jdiff.ddim_step(jdiff.make_schedule(jmodel.config),
                               jnp.asarray(x), noise_j, jnp.asarray(t),
                               jnp.asarray(tp))
    k_vox_c, _, _, k_vox_x, _ = jax.random.split(k_fwd, 5)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        pred_t, idx_t, _ = tmodel.forward(
            xt, torch.full((1,), t), torch.from_numpy(cond),
            cond_priority=torch.from_numpy(uniform(k_vox_c, n)),
            noisy_priority=torch.from_numpy(uniform(k_vox_x, n)),
            fps_starts=FPS0)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx))
    noise_t = tsamp._upsample_unknown(xt, idx_t, pred_t.float(), "pallas")
    np.testing.assert_allclose(noise_t.numpy(), np.asarray(noise_j),
                               rtol=1e-5, atol=1e-5)
    x_next_t = tsamp.ddim_step(make_schedule(tmodel.config), xt, noise_t, t,
                               tp)
    np.testing.assert_allclose(x_next_t.numpy(), np.asarray(x_next_j),
                               rtol=1e-5, atol=1e-5)


def test_ddim_50_steps_float32(rng, key, monkeypatch, interpret_jax_kernels):
    got, want, gap = run_ddim(key, rng, monkeypatch, STEPS,
                              perturb_jax_again=True)
    assert chamfer(got, want) <= max(1e-3, 2 * gap), gap


def test_ddim_direct_branch_matches_jax(rng, key, monkeypatch):
    """N <= global_points: no voxel selection, no upsampling."""
    pin_jax_encoder(monkeypatch)
    n = 100
    jmodel, variables, tmodel = models(key, rng, **HIER)
    _, cond = clouds(rng, n)
    shape_like = np.zeros((1, n, 3), np.float32)
    want = np.asarray(jsamp.ddim_sample_loop(
        jmodel, jdiff.make_schedule(jmodel.config), variables,
        jnp.asarray(shape_like), jnp.asarray(cond), key,
        num_inference_steps=10))
    x0, _, _ = ddim_draws(key, 10, n, n, HIER["global_points"])
    got = ddim_sample_loop(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(shape_like),
        torch.from_numpy(cond), num_inference_steps=10,
        x_init=torch.from_numpy(x0), fps_starts=FPS0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", ["pallas_f32packed", "pallas_pruned"])
def test_hierarchical_one_step_new_backends(rng, key, interpret_jax_kernels,
                                            backend):
    """One guided upsample from the same x_t and coarse noise through each
    new kNN backend: identical voxel partition, noise within 1e-5."""
    n, m = 512, 128
    x = rng.standard_normal((1, n, 3)).astype(np.float32)
    coarse = rng.standard_normal((1, m, 3)).astype(np.float32)
    k = jax.random.PRNGKey(5)
    sel, idx, comp, cxyz = jvox.voxel_downsample_partition(jnp.asarray(x), m, k)
    noise_j = jsamp._upsample_unknown(jnp.asarray(x), idx, jnp.asarray(coarse),
                                      backend, unknown=comp, ref_xyz=sel,
                                      unknown_xyz=cxyz)
    mn, size = jvox._voxel_geometry(jnp.asarray(x[0]), m)
    geom = (torch.from_numpy(np.array(mn))[None],
            torch.from_numpy(np.array(size))[None])
    xt = torch.from_numpy(x)
    t_sel, t_idx, t_comp, t_cxyz = voxel_downsample_partition(
        xt, m, priority=torch.from_numpy(uniform(k, n)), geometry=geom)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_comp.numpy(), np.asarray(comp))
    noise_t = tsamp._upsample_unknown(xt, t_idx, torch.from_numpy(coarse),
                                      backend, unknown=t_comp, ref_xyz=t_sel,
                                      unknown_xyz=t_cxyz)
    np.testing.assert_allclose(noise_t.numpy(), np.asarray(noise_j),
                               rtol=1e-5, atol=1e-5)
    # the recomputing form (no partition passed in) agrees
    again = tsamp._upsample_unknown(xt, t_idx, torch.from_numpy(coarse),
                                    backend)
    np.testing.assert_allclose(again.numpy(), noise_t.numpy(), rtol=1e-6,
                               atol=1e-6)
