"""The training loss (``models/losses.py``) against the JAX package's.

The JAX Chamfer term runs the TPU row-min kernel's custom VJP in interpret
mode and the port's plain kernels compute distances in XLA's CPU FMA form,
so both take the same argmins: loss terms within 1e-6 relative, gradients
within 1e-6 of each input's largest |g|. bf16 predictions: the L1 is taken
in float32 on both sides, so the terms agree to the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.models.losses import diffusion_loss
from pointcloud_style_transfer_tpu.models import losses as jax_losses

from torch_parity import pallas_vjp_min_sq_dist, xla_cpu_distances


def inputs(rng, b=2, n=40, m=64):
    a = rng.standard_normal((b, n, 3)).astype(np.float32)
    t = rng.standard_normal((b, n, 3)).astype(np.float32)
    p = rng.standard_normal((b, m, 3)).astype(np.float32)
    q = rng.standard_normal((b, m, 3)).astype(np.float32)
    q[:, :10] = p[:, 5:15]  # zero-distance pairs
    return a, t, p, q


@pytest.mark.parametrize("weight", [0.1, 0.0])
def test_loss_terms_match_jax(rng, monkeypatch, weight):
    pallas_vjp_min_sq_dist(monkeypatch)
    a, t, p, q = inputs(rng)
    _, want = jax_losses.diffusion_loss(*map(jnp.asarray, (a, t, p, q)),
                                        chamfer_weight=weight)
    with xla_cpu_distances():
        total, got = diffusion_loss(*map(torch.from_numpy, (a, t, p, q)),
                                    chamfer_weight=weight)
    assert set(got) == set(want)
    assert ("chamfer_loss" in got) == (weight > 0)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
    assert got["total_loss"] is total


def test_l1_only_without_coarse_points(rng):
    a, t, _, _ = inputs(rng)
    total, d = diffusion_loss(torch.from_numpy(a), torch.from_numpy(t))
    _, want = jax_losses.diffusion_loss(jnp.asarray(a), jnp.asarray(t))
    assert set(d) == set(want) == {"noise_loss", "total_loss"}
    np.testing.assert_allclose(total.item(), float(want["total_loss"]),
                               rtol=1e-6)


def test_bf16_prediction_l1_in_float32(rng):
    a, t, _, _ = inputs(rng)
    a_bf = torch.from_numpy(a).bfloat16()
    _, d = diffusion_loss(a_bf, torch.from_numpy(t))
    _, want = jax_losses.diffusion_loss(jnp.asarray(a).astype(jnp.bfloat16),
                                        jnp.asarray(t))
    assert d["noise_loss"].dtype == torch.float32
    np.testing.assert_allclose(d["noise_loss"].item(),
                               float(want["noise_loss"]), rtol=1e-6)


def test_loss_gradients_match_jax(rng, monkeypatch):
    pallas_vjp_min_sq_dist(monkeypatch)
    a, t, p, q = inputs(rng)

    def jloss(a_, p_):
        return jax_losses.diffusion_loss(a_, jnp.asarray(t), p_,
                                         jnp.asarray(q))[0]
    ga, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(p))
    at = torch.from_numpy(a).requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    with xla_cpu_distances():
        total, _ = diffusion_loss(at, torch.from_numpy(t), pt,
                                  torch.from_numpy(q))
        total.backward()
    for got, want in ((at.grad, ga), (pt.grad, gp)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
