"""Helpers shared by the port's parity tests against the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_style_transfer_tpu.models import networks as jnet
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
