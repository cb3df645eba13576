"""kNN inverse-distance upsampling: the port's ``ops/interpolate.py`` vs the
JAX package's (its brute kNN kernel in interpret mode; the port's plain
distances in XLA's CPU form). Neighbour indices identical; weights within
1e-6 (a reciprocal and a normalisation of identical distances); applied
values within 1e-6 of the value scale."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import (apply_interpolation,
                                                 knn_interpolate,
                                                 knn_interpolate_weights)
from pointcloud_style_transfer_tpu.ops import interpolate as J
from pointcloud_style_transfer_tpu.ops.pallas import distance_topk, pruned_knn

from torch_parity import xla_cpu_distances


@pytest.fixture
def interpret_jax_kernels(monkeypatch):
    for mod, name in ((distance_topk, "pallas_knn"),
                      (distance_topk, "pallas_knn_f32packed"),
                      (pruned_knn, "pallas_knn_pruned")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))


def cloud(rng, b, n, m):
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    pts[:, : n // 10] = pts[:, n // 10: 2 * (n // 10)]  # exact duplicates
    idx = np.stack([rng.permutation(n)[:m] for _ in range(b)]).astype(np.int32)
    return pts, idx


@pytest.mark.parametrize("backend", ["pallas", "pallas_f32packed",
                                     "pallas_pruned"])
def test_weights_match_jax(rng, interpret_jax_kernels, backend):
    pts, idx = cloud(rng, 2, 700, 200)
    nbr_j, w_j = J.knn_interpolate_weights(jnp.asarray(pts), jnp.asarray(idx),
                                           k=3, backend=backend)
    with xla_cpu_distances():
        nbr_t, w_t = knn_interpolate_weights(
            torch.from_numpy(pts), torch.from_numpy(idx), 3, backend)
    assert nbr_t.dtype == torch.int32 and w_t.dtype == torch.float32
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w_t.sum(-1).numpy(), 1.0, atol=1e-6)


def test_apply_and_interpolate_match_jax(rng, interpret_jax_kernels):
    pts, idx = cloud(rng, 2, 500, 120)
    vals = rng.standard_normal((2, 120, 4)).astype(np.float32)
    want = J.knn_interpolate(jnp.asarray(vals), jnp.asarray(pts),
                             jnp.asarray(idx), k=3, backend="pallas")
    with xla_cpu_distances():
        got = knn_interpolate(torch.from_numpy(vals), torch.from_numpy(pts),
                              torch.from_numpy(idx), 3, "pallas")
        nbr, w = knn_interpolate_weights(torch.from_numpy(pts),
                                         torch.from_numpy(idx), 3, "pallas")
    assert got.shape == (2, 500, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(vals).max())
    # the known slots hold their coarse values exactly
    for b in range(2):
        assert torch.equal(got[b, idx[b].astype(np.int64)],
                           torch.from_numpy(vals[b]))
    # values keep their dtype; out-of-range coarse indices are clipped
    bf = apply_interpolation(torch.from_numpy(vals).bfloat16(), nbr, w,
                             torch.from_numpy(idx))
    assert bf.dtype == torch.bfloat16
    far = idx.copy()
    far[:, 0] = 10_000
    out = apply_interpolation(torch.from_numpy(vals), nbr, w,
                              torch.from_numpy(far))
    want = J.apply_interpolation(jnp.asarray(vals), jnp.asarray(nbr.numpy()),
                                 jnp.asarray(w.numpy()), jnp.asarray(far))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(vals).max())


def test_k_is_clamped_to_the_coarse_set(rng, interpret_jax_kernels):
    pts, idx = cloud(rng, 1, 50, 2)
    nbr_j, w_j = J.knn_interpolate_weights(jnp.asarray(pts), jnp.asarray(idx),
                                           k=3, backend="pallas")
    with xla_cpu_distances():
        nbr_t, w_t = knn_interpolate_weights(torch.from_numpy(pts),
                                             torch.from_numpy(idx), 3)
    assert nbr_t.shape == (1, 50, 2)
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)
