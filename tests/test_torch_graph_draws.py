"""The samplers' draws, taken before the loop: what the card's captured
program needs (no generator inside a CUDA graph) and what keeps one seed's
numbers the same on the CPU and on the card.

* Each sampler drawing from a generator gives exactly the cloud it gives
  with its draws made by hand from an identically seeded generator, in the
  documented order, and passed in: ``guided_sample_loop`` (condition
  priorities, the two FPS starts, the initial noise, each step's
  priorities), ``guided_sample_loop_coarse`` (condition priorities, FPS
  starts, source priorities, the coarse initial noise) and
  ``ddim_sample_loop`` (the initial noise, then each step's condition
  priorities, FPS starts and state priorities).
* ``guided_sample_loop`` at B = 2 on the flat-batched grid with its draws
  passed in against the JAX sampler with the same draws (its Pallas
  kernels in interpret mode), held as the 50-step sampler tests hold it:
  Chamfer-L2 <= max(1e-3, 2x the distance between two JAX runs whose
  initial noise differs by one ulp), each cloud.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (
    PointCloudDiffusionModel, ddim_sample_loop, guided_sample_loop,
    guided_sample_loop_coarse, make_schedule)
from pointcloud_style_transfer_torch.models import capture
from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_tpu.models import diffusion as jdiff
from pointcloud_style_transfer_tpu.models import samplers as jsamp

from torch_parity import chamfer, models, pin_jax_encoder, sampler_draws

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

N, M, STEPS = 1024, 256, 2


@pytest.fixture
def small_model():
    torch.manual_seed(0)
    cfg = Config(total_points=N, global_points=M, feature_dim=32,
                 time_embed_dim=16, use_amp=False)
    return PointCloudDiffusionModel(cfg, device="cpu"), make_schedule(cfg)


def clouds(B):
    g = torch.Generator().manual_seed(7)
    return (torch.randn((B, N, 3), generator=g) * 0.8,
            torch.randn((B, N, 3), generator=g) * 0.8)


def fps_pair(g, n, B):
    """The encoder's two FPS starts as its forward draws them."""
    return torch.stack([torch.randint(0, n, (B,), generator=g),
                        torch.randint(0, 512, (B,), generator=g)])


def test_guided_draw_order(small_model):
    model, schedule = small_model
    B = 2
    src, cond = clouds(B)
    got = guided_sample_loop(model, schedule, src, cond, STEPS, 7.5,
                             generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    draws = dict(cond_priority=torch.rand((B, N), generator=g),
                 fps_starts=fps_pair(g, M, B),
                 x_init=torch.randn((B, N, 3), generator=g))
    draws["step_priorities"] = torch.stack(
        [torch.rand((B, N), generator=g) for _ in range(STEPS)])
    want = guided_sample_loop(model, schedule, src, cond, STEPS, 7.5,
                              **draws)
    assert torch.equal(got, want)


def test_coarse_draw_order(small_model):
    model, schedule = small_model
    src, cond = clouds(1)
    got = guided_sample_loop_coarse(
        model, schedule, src, cond, STEPS, 7.5,
        generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    draws = dict(cond_priority=torch.rand((1, N), generator=g),
                 fps_starts=fps_pair(g, M, 1),
                 src_priority=torch.rand((1, N), generator=g),
                 x_init=torch.randn((1, M, 3), generator=g))
    want = guided_sample_loop_coarse(model, schedule, src, cond, STEPS, 7.5,
                                     **draws)
    assert torch.equal(got, want)


def test_ddim_draw_order(small_model):
    model, schedule = small_model
    src, cond = clouds(1)
    got = ddim_sample_loop(model, schedule, src, cond, STEPS,
                           generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    x_init = torch.randn((1, N, 3), generator=g)
    per_step = [(torch.rand((1, N), generator=g), fps_pair(g, M, 1),
                 torch.rand((1, N), generator=g)) for _ in range(STEPS)]
    cond_p, fps, state_p = (torch.stack(d) for d in zip(*per_step))
    want = ddim_sample_loop(model, schedule, src, cond, STEPS, x_init=x_init,
                            cond_priorities=cond_p, fps_starts=fps,
                            step_priorities=state_p)
    assert torch.equal(got, want)
    # one pair of FPS starts for every step, as before
    once = ddim_sample_loop(model, schedule, src, cond, STEPS, x_init=x_init,
                            cond_priorities=cond_p, fps_starts=fps[0],
                            step_priorities=state_p)
    twice = ddim_sample_loop(model, schedule, src, cond, STEPS,
                             x_init=x_init, cond_priorities=cond_p,
                             fps_starts=fps[0].expand(STEPS, 2, 1),
                             step_priorities=state_p)
    assert torch.equal(once, twice)


def test_model_key_follows_the_tensors(small_model):
    """A captured graph reads the model's tensors in place: its key keeps
    when they are updated in place and changes when one is replaced."""
    model, _ = small_model
    key = capture.model_key(model)
    with torch.no_grad():
        next(model.net.parameters()).add_(1.0)
    assert capture.model_key(model) == key
    lin = model.net.noise_predictor.output_mlp[2]
    lin.weight = torch.nn.Parameter(lin.weight.detach().clone())
    assert capture.model_key(model) != key


SAMPLER_GRID = dict(grid_shape=(4, 4, 4), tq=32, slot_cap=256,
                    fallback_cap=512)


def test_predrawn_batch_of_two_matches_jax(rng, key, monkeypatch):
    """B = 2 on the flat-batched grid (a (4, 4, 4)/256 grid, under which
    1,024 coarse points take whole columns), every draw passed in, against
    the JAX sampler with the same draws."""
    pin_jax_encoder(monkeypatch)
    for name in ("grid_knn_interpolate_layout", "grid_knn_interpolate"):
        monkeypatch.setattr(J, name, functools.partial(
            getattr(J, name), interpret=True, **SAMPLER_GRID))
        monkeypatch.setattr(P, name, functools.partial(getattr(P, name),
                                                       **SAMPLER_GRID))
    B, n, m, steps = 2, 2048, 1024, 4
    jmodel, variables, tmodel = models(
        key, rng, total_points=n, global_points=m, feature_dim=32,
        time_embed_dim=16, use_amp=False, knn_backend="grid")
    src = (rng.standard_normal((B, n, 3)) * 0.8).astype(np.float32)
    cond = (rng.standard_normal((B, n, 3)) * 0.8).astype(np.float32)
    x0 = rng.standard_normal((B, n, 3)).astype(np.float32)

    def jax_run(x_init):
        return np.asarray(jsamp.guided_sample_loop(
            jmodel, jdiff.make_schedule(jmodel.config), variables,
            jnp.asarray(src), jnp.asarray(cond), key,
            num_inference_steps=steps, guidance_scale=7.5,
            x_init=jnp.asarray(x_init)))
    want = jax_run(x0)
    gap = jax_run(x0 * np.float32(1 + 2**-23))
    cond_u, step_u = sampler_draws(key, steps, n, n, m, batch=B)
    P.UNSAFE_COUNTS.clear()
    got = guided_sample_loop(
        tmodel, make_schedule(tmodel.config), torch.from_numpy(src),
        torch.from_numpy(cond), num_inference_steps=steps, guidance_scale=7.5,
        x_init=torch.from_numpy(x0), cond_priority=torch.from_numpy(cond_u),
        step_priorities=torch.from_numpy(step_u),
        fps_starts=torch.zeros((2, B), dtype=torch.int64)).numpy()
    assert len(P.unsafe_counts()) == steps * B  # one flat pass a step
    assert np.isfinite(got).all() and got.shape == (B, n, 3)
    for b in range(B):
        self_gap = chamfer(gap[b:b + 1], want[b:b + 1])
        assert chamfer(got[b:b + 1], want[b:b + 1]) <= max(1e-3,
                                                           2 * self_gap)
