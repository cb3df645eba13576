"""guided_sample_loop: the port vs the JAX package with converted weights
and the same draws (initial noise, voxel priorities; FPS starts pinned to 0).

* direct branch (N <= global_points), float32, 50 steps: eval Chamfer-L2
  <= 1e-3 and pointwise 5e-2, the bars of the JAX package's own end-to-end
  parity test (measured: 7e-5 and 1.7e-4). In bf16, the default compute
  dtype, each framework rounds to bf16 at other places and the guidance
  scale amplifies that: measured Chamfer-L2 0.016 after 50 steps, held
  at 0.035;
* hierarchical branch, float32: one step from the same x_t gives identical
  voxel indices and noise within 1e-5 (relative to the noise's magnitude:
  float32 matmul rounding times the guidance scale). Over 50 steps the
  voxel selection is discontinuous in x: a float32 rounding difference
  moves a point across a voxel face, changes the coarse set, and the runs
  part. The JAX package is exactly as sensitive to itself, so the port is
  held to Chamfer-L2 <= max(1e-3, 2x the distance between two JAX runs
  whose initial noise differs by one ulp) (measured here: port vs JAX
  7.2e-3, JAX vs JAX 7.3e-3). The JAX side runs its brute kNN kernel (interpret
  mode), not the CPU default's matmul-expansion kNN, whose distances to
  near neighbours carry large relative errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (guided_sample_loop,
                                                    make_schedule)
from pointcloud_style_transfer_torch.models import samplers as tsamp
from pointcloud_style_transfer_torch.models.diffusion import ddim_step
from pointcloud_style_transfer_torch.ops import voxel_downsample_partition
from pointcloud_style_transfer_tpu.models import diffusion as jdiff
from pointcloud_style_transfer_tpu.models import samplers as jsamp
from pointcloud_style_transfer_tpu.ops import voxel as jvox
from pointcloud_style_transfer_tpu.ops.pallas import distance_topk

from torch_parity import chamfer, models, pin_jax_encoder, sampler_draws

STEPS, SCALE = 50, 7.5


@pytest.mark.parametrize("use_amp,max_chamfer,atol", [
    (False, 1e-3, 5e-2), (True, 0.035, 0.1)])
def test_direct_branch_50_steps(rng, key, monkeypatch, use_amp, max_chamfer,
                                atol):
    pin_jax_encoder(monkeypatch)
    n = 256
    jmodel, variables, tmodel = models(key, rng, total_points=n,
                                       global_points=1024, use_amp=use_amp)
    src = (rng.standard_normal((1, n, 3)) * 0.8).astype(np.float32)
    cond = (rng.standard_normal((1, n, 3)) * 0.8).astype(np.float32)
    x0 = rng.standard_normal((1, n, 3)).astype(np.float32)
    want = np.asarray(jsamp.guided_sample_loop(
        jmodel, jdiff.make_schedule(jmodel.config), variables,
        jnp.asarray(src), jnp.asarray(cond), key, num_inference_steps=STEPS,
        guidance_scale=SCALE, x_init=jnp.asarray(x0)))
    got = guided_sample_loop(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(src),
        torch.from_numpy(cond), num_inference_steps=STEPS,
        guidance_scale=SCALE, x_init=torch.from_numpy(x0),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64)).numpy()
    assert np.isfinite(got).all() and got.shape == (1, n, 3)
    assert chamfer(got, want) <= max_chamfer
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


HIER = dict(total_points=512, global_points=128, feature_dim=32,
            time_embed_dim=16, use_amp=False, knn_backend="pallas")


def interpret_jax_knn(monkeypatch):
    monkeypatch.setattr(distance_topk, "pallas_knn",
                        functools.partial(distance_topk.pallas_knn,
                                          interpret=True))


def test_hierarchical_one_step_float32(rng, key, monkeypatch):
    interpret_jax_knn(monkeypatch)
    n, m, t, tp = 512, 128, 500, 480
    jmodel, variables, tmodel = models(key, rng, **HIER)
    x = rng.standard_normal((1, n, 3)).astype(np.float32)
    src = (rng.standard_normal((1, n, 3)) * 0.8).astype(np.float32)
    style = rng.standard_normal((1, 32)).astype(np.float32)
    style_in = np.concatenate([style, np.zeros_like(style)])

    k = jax.random.PRNGKey(5)
    sel, idx, comp, cxyz = jvox.voxel_downsample_partition(jnp.asarray(x), m, k)
    pred = jmodel.predict_noise(variables, jnp.concatenate([sel, sel]),
                                jnp.full((2,), t, jnp.int32),
                                jnp.asarray(style_in))
    nc, nu = jnp.split(pred.astype(jnp.float32), 2)
    noise_j = jsamp._upsample_unknown(jnp.asarray(x), idx, nu + SCALE * (nc - nu),
                                      "pallas", unknown=comp, ref_xyz=sel,
                                      unknown_xyz=cxyz)
    x_next_j = jdiff.ddim_step(jdiff.make_schedule(jmodel.config),
                               jnp.asarray(x), noise_j, jnp.asarray(t),
                               jnp.asarray(tp), source_points=jnp.asarray(src),
                               content_anchor=0.1)

    u = np.array(jax.random.uniform(jax.random.split(k, 1)[0], (n,)))[None]
    mn, size = jvox._voxel_geometry(jnp.asarray(x[0]), m)
    geom = (torch.from_numpy(np.array(mn))[None],
            torch.from_numpy(np.array(size))[None])
    xt = torch.from_numpy(x)
    t_sel, t_idx, t_comp, t_cxyz = voxel_downsample_partition(
        xt, m, priority=torch.from_numpy(u), geometry=geom)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_comp.numpy(), np.asarray(comp))
    pred_t = tmodel.predict_noise(torch.cat([t_sel, t_sel]),
                                  torch.full((2,), t),
                                  torch.from_numpy(style_in)).float()
    tc, tu = pred_t.chunk(2)
    noise_t = tsamp._upsample_unknown(xt, t_idx, tu + SCALE * (tc - tu),
                                      "pallas", unknown=t_comp,
                                      ref_xyz=t_sel, unknown_xyz=t_cxyz)
    np.testing.assert_allclose(noise_t.numpy(), np.asarray(noise_j),
                               rtol=1e-5, atol=1e-5)
    x_next_t = ddim_step(make_schedule(tmodel.config), xt, noise_t, t, tp,
                         source_points=torch.from_numpy(src),
                         content_anchor=0.1)
    np.testing.assert_allclose(x_next_t.numpy(), np.asarray(x_next_j),
                               rtol=1e-5, atol=1e-5)


def test_hierarchical_50_steps_float32(rng, key, monkeypatch):
    pin_jax_encoder(monkeypatch)
    interpret_jax_knn(monkeypatch)
    n, m = 512, 128
    jmodel, variables, tmodel = models(key, rng, **HIER)
    src = (rng.standard_normal((1, n, 3)) * 0.8).astype(np.float32)
    cond = (rng.standard_normal((1, n, 3)) * 0.8).astype(np.float32)
    x0 = rng.standard_normal((1, n, 3)).astype(np.float32)

    def jax_run(x_init):
        return np.asarray(jsamp.guided_sample_loop(
            jmodel, jdiff.make_schedule(jmodel.config), variables,
            jnp.asarray(src), jnp.asarray(cond), key,
            num_inference_steps=STEPS, guidance_scale=SCALE,
            x_init=jnp.asarray(x_init)))
    want = jax_run(x0)
    self_gap = chamfer(jax_run((x0 * np.float32(1 + 2**-23))), want)
    cond_u, step_u = sampler_draws(key, STEPS, n, n, m)
    got = guided_sample_loop(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(src),
        torch.from_numpy(cond), num_inference_steps=STEPS,
        guidance_scale=SCALE, x_init=torch.from_numpy(x0),
        cond_priority=torch.from_numpy(cond_u),
        step_priorities=torch.from_numpy(step_u),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64)).numpy()
    assert np.isfinite(got).all() and got.shape == (1, n, 3)
    assert chamfer(got, want) <= max(1e-3, 2 * self_gap), self_gap


def test_knn_backend_resolution():
    resolve = tsamp.resolve_sampler_knn_backend
    assert resolve(Config()) == "grid"  # "auto" is the kd-grid, as on the TPU
    assert resolve(Config(knn_backend="grid")) == "grid"
    assert resolve(Config(knn_backend="pallas")) == "pallas"
    assert resolve(Config(knn_backend="jnp")) == "jnp"
    assert resolve(Config(use_pallas=False)) == "jnp"
    with pytest.raises(ValueError):
        resolve(Config(knn_backend="nope"))
    for b in ("pallas_f32packed", "pallas_pruned"):
        assert resolve(Config(knn_backend=b)) == b


def test_knn_backend_env_hook(monkeypatch):
    """``PCST_SAMPLER_KNN_BACKEND`` is honoured only when the config says
    "auto" and the kernels are on; an unknown value raises."""
    resolve = tsamp.resolve_sampler_knn_backend
    for value in tsamp.KNN_BACKENDS:
        monkeypatch.setenv("PCST_SAMPLER_KNN_BACKEND", value)
        assert resolve(Config()) == value
        assert resolve(Config(knn_backend="pallas")) == "pallas"
        assert resolve(Config(use_pallas=False)) == "jnp"
    monkeypatch.setenv("PCST_SAMPLER_KNN_BACKEND", "palas")
    with pytest.raises(ValueError, match="PCST_SAMPLER_KNN_BACKEND"):
        resolve(Config())
    assert resolve(Config(knn_backend="grid")) == "grid"  # pinned: not read
    monkeypatch.setenv("PCST_SAMPLER_KNN_BACKEND", "")
    assert resolve(Config()) == "grid"
