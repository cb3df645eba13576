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


def models(key, rng, jit=False, **cfg_kw):
    """The same (perturbed) weights in a JAX model and a port model. With
    ``jit`` the JAX init runs as one compiled program: the same values,
    seconds faster than op by op in a process that has compiled nothing."""
    jmodel = JaxModel(JaxConfig(**cfg_kw))
    init = functools.partial(jmodel.init, example_points=256)
    variables = (jax.jit(init) if jit else init)(key)
    variables = {"params": perturbed(variables["params"], rng),
                 "batch_stats": perturbed(variables["batch_stats"], rng)}
    tmodel = PointCloudDiffusionModel(Config(**cfg_kw), device="cpu")
    tmodel.net.load_state_dict(flax_to_torch(variables))
    return jmodel, variables, tmodel


def sampler_draws(key, steps, n_cond, n, m, batch=1):
    """The voxel priorities JAX's guided_sample_loop draws from ``key`` for
    a batch of ``batch`` clouds: ([batch, n_cond] | None,
    [steps, batch, n])."""
    k_cond, _, _, k_steps = jax.random.split(key, 4)
    uniform = lambda k, size: np.stack([  # noqa: E731
        np.array(jax.random.uniform(kb, (size,)))
        for kb in jax.random.split(k, batch)])
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


def xla_cpu_selected_sq_dist(query, sel):
    """The packed kNN wrappers' recomputed distances ``sum((q - sel)**2)`` as
    XLA's CPU backend fuses them under jit: fma(dz, dz, fma(dy, dy, dx*dx))."""
    d = query[:, :, None, :] - sel
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return fma32(z, z, fma32(y, y, x * x))


@contextlib.contextmanager
def xla_cpu_distances(jit_recompute=True):
    """Make the port's plain kernels (grid, brute, packed and pruned kNN,
    row minimum) compute distances as the JAX kernels do in interpret mode
    on the CPU, so that parity with them can be held bit for bit.
    ``jit_recompute`` also switches the packed kNN wrappers' recomputed
    distances to the form XLA gives them under jit (run eagerly, JAX
    computes them op by op, as the port does)."""
    from pointcloud_style_transfer_torch.ops.kernels import (
        grid, knn, knn_packed, knn_pruned, rowmin)
    patches = [(m, "pairwise_sq_dist", xla_cpu_sq_dist)
               for m in (grid, knn, knn_packed, knn_pruned, rowmin)]
    if jit_recompute:
        patches.append((knn_packed, "selected_sq_dist",
                        xla_cpu_selected_sq_dist))
    saved = [getattr(m, name) for m, name, _ in patches]
    for m, name, f in patches:
        setattr(m, name, f)
    try:
        yield
    finally:
        for (m, name, _), f in zip(patches, saved):
            setattr(m, name, f)


def pallas_vjp_min_sq_dist(monkeypatch):
    """The JAX package's Chamfer (training loss and metrics) through the
    TPU row-min kernel and its custom VJP in interpret mode, as on the TPU;
    on the CPU it would take the jnp matmul expansion, whose gradient
    through ``jnp.min`` splits ties."""
    from pointcloud_style_transfer_tpu.evaluation import metrics
    from pointcloud_style_transfer_tpu.ops import distance
    from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import \
        pallas_min_sq_dist

    def min_sq_dist(query, ref, chunk_size=2048, backend=None):
        return pallas_min_sq_dist(query, ref, True)
    monkeypatch.setattr(distance, "min_sq_dist", min_sq_dist)
    monkeypatch.setattr(metrics, "min_sq_dist", min_sq_dist)


def blocked_flax_batchnorm_stats(monkeypatch, blocks=64):
    """Flax BatchNorm's training statistics, the same formula (mean and the
    biased fast variance max(0, E[x^2] - E[x]^2) over every axis but the
    last, in float32) with each sum taken over ``blocks`` row blocks first.

    XLA's CPU reduction of the style encoder's 32,768 rows in one pass
    carries ~3e-5 relative error against float64 (measured), ~50x the
    port's, and it feeds the whole step; blocked sums bring the reference
    to the port's accuracy. The optimization barrier keeps XLA from fusing
    the two stages back into one reduction under jit."""
    from flax.linen import normalization

    def compute_stats(x, axes, dtype, *args, **kwargs):
        assert sorted(a % x.ndim for a in axes) == list(range(x.ndim - 1))
        f = x.astype(jnp.float32).reshape(-1, x.shape[-1])
        n = f.shape[0]
        g = f.reshape(blocks, n // blocks, -1) if n % blocks == 0 else f[None]
        s1, s2 = jax.lax.optimization_barrier((g.sum(1), (g * g).sum(1)))
        mu, mu2 = s1.sum(0) / n, s2.sum(0) / n
        return mu, jnp.maximum(0.0, mu2 - mu * mu)
    monkeypatch.setattr(normalization, "_compute_stats", compute_stats)


def port_schedule(jax_schedule):
    """The JAX schedule's float32 tables as a port schedule, so that both
    packages noise with the same numbers."""
    from pointcloud_style_transfer_torch.models.diffusion import \
        DiffusionSchedule
    names = ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
             "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod")
    return DiffusionSchedule(**{n: torch.from_numpy(np.array(
        getattr(jax_schedule, n))) for n in names})
