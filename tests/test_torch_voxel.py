"""Voxel downsample (mean_index rule) vs the JAX package with the same
priorities and voxel geometry: identical indices and complements, exact
coordinates; each cloud of a batch equals its own B=1 result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import voxel as tvox
from pointcloud_style_transfer_tpu.ops import voxel as jvox


def cloud(rng, b, n, dup_frac=0.1):
    pts = (rng.standard_normal((b, n, 3)) * [1.0, 0.6, 0.2]).astype(np.float32)
    k = int(n * dup_frac)
    pts[:, rng.choice(n, k, replace=False)] = pts[:, rng.choice(n, k)]
    return pts


def jax_draws(key, b, n):
    """The priorities JAX draws inside voxel_downsample*(points, M, key)."""
    keys = jax.random.split(key, b)
    return np.stack([np.array(jax.random.uniform(keys[i], (n,)))
                     for i in range(b)])


def jax_geometry(pts, m):
    mins, sizes = zip(*(jvox._voxel_geometry(jnp.asarray(p), m) for p in pts))
    return (torch.from_numpy(np.stack([np.asarray(x) for x in mins])),
            torch.from_numpy(np.array([np.asarray(s) for s in sizes])))


@pytest.mark.parametrize("b,n,m", [(1, 2000, 500), (3, 1500, 300),
                                   (2, 700, 650)])
def test_partition_matches_jax(rng, b, n, m):
    pts = cloud(rng, b, n)
    key = jax.random.PRNGKey(11)
    sel_j, idx_j, comp_j, cxyz_j = jvox.voxel_downsample_partition(
        jnp.asarray(pts), m, key)
    u = torch.from_numpy(jax_draws(key, b, n))
    geom = jax_geometry(pts, m)
    sel, idx, comp, cxyz = tvox.voxel_downsample_partition(
        torch.from_numpy(pts), m, priority=u, geometry=geom)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(comp_j))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(cxyz.numpy(), np.asarray(cxyz_j))
    # each cloud of the batch is its own B=1 result
    for i in range(b):
        one = tvox.voxel_downsample_partition(
            torch.from_numpy(pts[i:i + 1]), m, priority=u[i:i + 1],
            geometry=(geom[0][i:i + 1], geom[1][i:i + 1]))
        np.testing.assert_array_equal(one[1][0].numpy(), idx[i].numpy())
        np.testing.assert_array_equal(one[2][0].numpy(), comp[i].numpy())


def test_downsample_matches_jax(rng):
    pts = cloud(rng, 2, 1200)
    key = jax.random.PRNGKey(3)
    ds_j, idx_j = jvox.voxel_downsample(jnp.asarray(pts), 400, key)
    ds, idx = tvox.voxel_downsample(
        torch.from_numpy(pts), 400, priority=torch.from_numpy(
            jax_draws(key, 2, 1200)), geometry=jax_geometry(pts, 400))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ds.numpy(), np.asarray(ds_j))


def test_tied_priorities_match_jax(rng, monkeypatch):
    """Priority ties (routine among 120k float32 draws) keep index order in
    both packages: the draws here take only 8 values."""
    pts = cloud(rng, 1, 900)
    u = (rng.integers(0, 8, 900) / 8).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda k, shape: jnp.asarray(u))
    idx_j, comp_j, sel_j, cxyz_j = jvox._downsample_single(
        jnp.asarray(pts[0]), jax.random.PRNGKey(0), 300, "mean_index",
        with_coords=True)
    sel, idx, comp, cxyz = tvox.voxel_downsample_partition(
        torch.from_numpy(pts), 300, priority=torch.from_numpy(u)[None],
        geometry=jax_geometry(pts, 300))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(comp[0].numpy(), np.asarray(comp_j))
    np.testing.assert_array_equal(cxyz[0].numpy(), np.asarray(cxyz_j))


def test_own_geometry_and_identity(rng):
    """Without injected geometry the port's voxel size matches XLA's
    cbrt on all but a few inputs (one ulp: ROADMAP queue 3); small clouds
    come back unchanged."""
    ratios = rng.uniform(1e-6, 1.0, 20000).astype(np.float32)
    ours = torch.pow(torch.from_numpy(ratios).double(), tvox._THIRD).float()
    ref = np.asarray(jnp.cbrt(jnp.asarray(ratios)))
    off = ours.numpy() != ref
    assert off.mean() < 0.005, off.mean()
    ulps = np.abs(ours.numpy().view(np.int32) - ref.view(np.int32))
    assert ulps.max() <= 1
    pts = cloud(rng, 1, 800)
    mn, size = tvox.voxel_geometry(torch.from_numpy(pts[0]), 200)
    mn_j, size_j = jvox._voxel_geometry(jnp.asarray(pts[0]), 200)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(mn_j))
    np.testing.assert_allclose(size.numpy(), np.asarray(size_j), rtol=2e-7)
    x = torch.from_numpy(pts)
    ds, idx = tvox.voxel_downsample(x, 800)
    assert ds is x and torch.equal(idx[0], torch.arange(800))
    sel, idx, comp, cxyz = tvox.voxel_downsample_partition(x, 900)
    assert comp.shape == (1, 0) and cxyz.shape == (1, 0, 3)
    g = torch.Generator().manual_seed(0)
    a = tvox.voxel_downsample_partition(x, 300, generator=g)
    g = torch.Generator().manual_seed(0)
    b = tvox.voxel_downsample_partition(x, 300, generator=g)
    assert torch.equal(a[1], b[1]) and a[1].shape == (1, 300)
    assert torch.equal(torch.sort(torch.cat([a[1], a[2]], 1)).values[0],
                       torch.arange(800))
