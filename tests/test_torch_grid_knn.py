"""The kd-grid's public entry points: the port vs the JAX package (kernels in
interpret mode) on clustered clouds with exact duplicate refs and queries on
refs, through each fallback tier: rows patched by the brute-force kernel,
and every row brute-forced once the unsafe rows outnumber the last tier
(which changes the tie rule from the lowest sorted position to the lowest
ref index).

The port's plain kernels compute distances as XLA's CPU backend does
(``xla_cpu_distances``), so neighbour ids, layout ids and distances must be
identical; interpolated values are held to rtol 1e-6 and atol 1e-6 * max|v|
(the kernels' weighted sums run in another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_torch.ops import knn

from torch_parity import xla_cpu_distances

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

GRID = dict(grid_shape=(4, 4, 5))
# fallback_cap -> tier: 4096 patches every unsafe row; 16 puts the unsafe
# count above the last tier (128 rows), so every row is brute-forced
TIERS = {"patched": 4096, "all_brute": 16}


def clustered(rng, m=800, n_cluster=1000, n_bg=1048, C=3):
    r = rng.standard_normal((m, 3)).astype(np.float32)
    r[rng.choice(m, m // 10, replace=False)] = r[rng.choice(m, m // 10)]
    cluster = rng.standard_normal((n_cluster, 3)).astype(np.float32) * 0.01
    bg = rng.standard_normal((n_bg, 3)).astype(np.float32) * 3
    q = np.concatenate([cluster + 0.001, bg])
    q[::9] = r[rng.choice(m, len(q[::9]))]
    v = rng.standard_normal((m, C)).astype(np.float32)
    return q, r, v


def assert_values_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def expect_tier(tier, n_rows, fallback_cap):
    n_unsafe = P.unsafe_counts()[-1]
    assert n_unsafe > 0
    last = P._fallback_caps(fallback_cap, n_rows)[-1]
    assert (n_unsafe > last) == (tier == "all_brute")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_grid_interpolate_layout_matches_jax(rng, tier):
    q, r, v = clustered(rng)
    cap = TIERS[tier]
    v_j, qid_j = J.grid_knn_interpolate_layout(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(v), k=3,
        fallback_cap=cap, interpret=True, **GRID)
    with xla_cpu_distances():
        v_p, qid_p = P.grid_knn_interpolate_layout(
            torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(v),
            k=3, fallback_cap=cap, **GRID)
    expect_tier(tier, len(q), cap)
    np.testing.assert_array_equal(qid_p.numpy(), np.asarray(qid_j))
    assert qid_p.dtype == torch.int32
    real = qid_p.numpy() < len(q)
    assert_values_close(v_p.numpy()[real], np.asarray(v_j)[real])


@pytest.mark.parametrize("B", [1, 2])
def test_grid_interpolate_matches_jax(rng, B):
    clouds = [clustered(rng, n_cluster=600, n_bg=700, C=4) for _ in range(B)]
    q, r, v = (np.stack(a) for a in zip(*clouds))
    want = J.grid_knn_interpolate(jnp.asarray(q), jnp.asarray(r),
                                  jnp.asarray(v), k=3, interpret=True, **GRID)
    with xla_cpu_distances():
        got = P.grid_knn_interpolate(torch.from_numpy(q), torch.from_numpy(r),
                                     torch.from_numpy(v), k=3, **GRID)
    assert got.shape == (B, q.shape[1], 4)
    assert_values_close(got.numpy(), want)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_grid_knn_matches_jax(rng, tier):
    q, r, _ = clustered(rng)
    cap = TIERS[tier]
    d_j, i_j = J.grid_knn(jnp.asarray(q)[None], jnp.asarray(r)[None], k=3,
                          fallback_cap=cap, interpret=True, **GRID)
    with xla_cpu_distances():
        d_p, i_p = P.grid_knn(torch.from_numpy(q)[None],
                              torch.from_numpy(r)[None], k=3,
                              fallback_cap=cap, **GRID)
    expect_tier(tier, len(q), cap)
    assert d_p.dtype == torch.float32 and i_p.dtype == torch.int32
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))


def test_knn_grid_backend_default_geometry(rng):
    """``knn(backend="grid")`` at the default (16,12,8)/384 grid against
    the brute-force kNN: distances identical, ids identical except between
    exactly equidistant refs."""
    q = (rng.standard_normal((1, 9000, 3)) * 2).astype(np.float32)
    r = (rng.standard_normal((1, 6500, 3)) * 2).astype(np.float32)
    r[0, :300] = r[0, 300:600]
    q[0, :500] = r[0, rng.choice(6500, 500)]
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    d_g, i_g = knn(qt, rt, 3, backend="grid")
    d_b, i_b = knn(qt, rt, 3, backend="pallas")
    assert torch.equal(d_g, d_b)
    differ = (i_g != i_b)[0]
    assert differ.sum() < 100
    # a differing id is another ref at exactly the same distance
    x = rt[0][i_g[0].long()] - qt[0][:, None]
    d_alt = ((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
             + x[..., 2] * x[..., 2])
    assert torch.equal(d_alt, d_b[0])


def test_small_ref_sets_go_brute(rng):
    q = rng.standard_normal((200, 3)).astype(np.float32)
    r = rng.standard_normal((30, 3)).astype(np.float32)
    v = rng.standard_normal((30, 2)).astype(np.float32)
    v_lay, qid = P.grid_knn_interpolate_layout(
        torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(v), k=3)
    assert qid.tolist() == list(range(200))
    want = J.grid_knn_interpolate_layout(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(v), k=3, interpret=True)[0]
    assert_values_close(v_lay.numpy(), want)
    d, i = P.grid_knn(torch.from_numpy(q)[None], torch.from_numpy(r)[None])
    d_b, i_b = knn(torch.from_numpy(q)[None], torch.from_numpy(r)[None], 3)
    assert torch.equal(d, d_b) and torch.equal(i, i_b)


def test_grid_entry_points_reject(rng):
    q = torch.zeros((1, 10, 3))
    with pytest.raises(ValueError, match="multiple of 128"):
        P.grid_knn(q, q, 3, slot_cap=200)
    with pytest.raises(ValueError, match="unbatched"):
        P.grid_knn_interpolate_layout(q, q[0], q[0])
    # exact=False is accepted: too few refs for the grid, so it is the
    # f32-packed brute force, whose distances here are the exact ones
    d, i = P.grid_knn(q, q, 3, exact=False)
    assert torch.equal(d, torch.zeros((1, 10, 3))) and i.dtype == torch.int32
