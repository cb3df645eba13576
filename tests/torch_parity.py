"""Helpers shared by the port's parity tests against the JAX package."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.convert import flax_to_torch
from pointcloud_style_transfer_torch.models import PointCloudDiffusionModel
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.models import \
    PointCloudDiffusionModel as JaxModel
from pointcloud_style_transfer_tpu.models import networks as jnet
from pointcloud_style_transfer_tpu.ops.distance import chamfer_distance_l2
from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import \
    pallas_ball_query
from pointcloud_style_transfer_tpu.ops.pallas.fps import \
    pallas_farthest_point_sample


def pin_jax_encoder(monkeypatch):
    """JAX encoder: FPS from index 0 and both kernels in interpret mode."""
    def fps(xyz, npoint, key, backend=None, start=None):
        return pallas_farthest_point_sample(
            xyz, npoint, key, interpret=True,
            start=jnp.zeros((xyz.shape[0],), jnp.int32))
    monkeypatch.setattr(jnet, "farthest_point_sample", fps)
    monkeypatch.setattr(jnet, "query_ball_point",
                        functools.partial(pallas_ball_query, interpret=True))


def perturbed(tree, rng):
    """Non-trivial values for the leaves that start at 0 or 1 (biases, BN
    scales and running stats), which would hide a swapped mapping; Dense
    kernels keep their random init."""
    def f(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.05, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def models(key, rng, **cfg_kw):
    """The same (perturbed) weights in a JAX model and a port model."""
    jmodel = JaxModel(JaxConfig(**cfg_kw))
    variables = jmodel.init(key, example_points=256)
    variables = {"params": perturbed(variables["params"], rng),
                 "batch_stats": perturbed(variables["batch_stats"], rng)}
    tmodel = PointCloudDiffusionModel(Config(**cfg_kw), device="cpu")
    tmodel.net.load_state_dict(flax_to_torch(variables))
    return jmodel, variables, tmodel


def sampler_draws(key, steps, n_cond, n, m):
    """The voxel priorities JAX's guided_sample_loop draws from ``key``."""
    k_cond, _, _, k_steps = jax.random.split(key, 4)
    uniform = lambda k, size: np.array(  # noqa: E731
        jax.random.uniform(jax.random.split(k, 1)[0], (size,)))[None]
    cond = uniform(k_cond, n_cond) if n_cond > m else None
    step_keys = jax.random.split(k_steps, steps)
    return cond, np.stack([uniform(k, n) for k in step_keys])


def chamfer(a, b):
    return float(chamfer_distance_l2(jnp.asarray(a), jnp.asarray(b))[0])


def fma32(a, b, c):
    """float32 fma(a, b, c), rounded once: a*b is exact in float64 and the
    float64 sum is rounded to odd (TwoSum residual), so the float32 rounding
    that follows is the correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).double()
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def xla_cpu_sq_dist(q, r):
    """The squared distances of the Pallas kernels as XLA's CPU backend
    computes them in interpret mode: it contracts (dx*dx + dy*dy) + dz*dz
    into fma(dz, dz, fma(dx, dx, dy*dy)), which differs in the last bit on
    about a fifth of the pairs."""
    dx = q[..., :, None, 0] - r[..., None, :, 0]
    dy = q[..., :, None, 1] - r[..., None, :, 1]
    dz = q[..., :, None, 2] - r[..., None, :, 2]
    return fma32(dz, dz, fma32(dx, dx, dy * dy))


@contextlib.contextmanager
def xla_cpu_distances():
    """Make the port's plain kernels (grid and brute kNN) compute distances
    as the JAX kernels do in interpret mode on the CPU, so that parity with
    them can be held bit for bit."""
    from pointcloud_style_transfer_torch.ops.kernels import grid, knn
    saved = grid.pairwise_sq_dist, knn.pairwise_sq_dist
    grid.pairwise_sq_dist = knn.pairwise_sq_dist = xla_cpu_sq_dist
    try:
        yield
    finally:
        grid.pairwise_sq_dist, knn.pairwise_sq_dist = saved
