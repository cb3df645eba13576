"""``ops.voxel``'s offline rule (``mode="center"``: each voxel's point
nearest its center) and ``voxel_downsample_with_complement`` against the
JAX package: identical indices and complements, at B = 1 (JAX's single
path) and B = 3 (its flat-batched sort), with exact duplicate points. The
per-cloud geometry (xyz_min, voxel size) is JAX's, passed in: the port's
voxel size can differ from XLA's ``cbrt`` by one ulp (ROADMAP queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import (
    voxel_downsample, voxel_downsample_partition,
    voxel_downsample_with_complement)
from pointcloud_style_transfer_tpu.ops import voxel as jvox


def jax_inputs(x, m, key):
    """JAX's per-cloud uniforms and geometry for ``key``."""
    keys = jax.random.split(key, x.shape[0])
    u = np.stack([np.asarray(jax.random.uniform(k, (x.shape[1],)))
                  for k in keys])
    mn, size = jax.vmap(lambda p: jvox._voxel_geometry(p, m))(jnp.asarray(x))
    return (torch.from_numpy(u),
            (torch.from_numpy(np.array(mn)), torch.from_numpy(np.array(size))))


def cloud(rng, b, n, scale):
    x = (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)
    k = n // 20
    x[:, :k] = x[:, k:2 * k]  # exact duplicates
    return x


@pytest.mark.parametrize("mode", ["center", "mean_index"])
@pytest.mark.parametrize("b, n, m, scale", [(1, 700, 256, 1.0),
                                            (3, 900, 300, 0.3),
                                            (2, 2048, 512, 5.0)])
def test_with_complement_matches_jax(rng, mode, b, n, m, scale):
    x = cloud(rng, b, n, scale)
    key = jax.random.PRNGKey(b * 100 + n)
    ds, idx, comp = jvox.voxel_downsample_with_complement(
        jnp.asarray(x), m, key, mode=mode)
    u, geom = jax_inputs(x, m, key)
    t_ds, t_idx, t_comp = voxel_downsample_with_complement(
        torch.from_numpy(x), m, priority=u, geometry=geom, mode=mode)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_comp.numpy(), np.asarray(comp))
    np.testing.assert_array_equal(t_ds.numpy(), np.asarray(ds))
    # the selection and its complement partition every cloud
    both = np.sort(np.concatenate([t_idx.numpy(), t_comp.numpy()], 1), 1)
    np.testing.assert_array_equal(both, np.broadcast_to(np.arange(n),
                                                        (b, n)))


@pytest.mark.parametrize("b", [1, 3])
def test_center_downsample_and_partition_match_jax(rng, b):
    n, m = 800, 200
    x = cloud(rng, b, n, 2.0)
    key = jax.random.PRNGKey(11)
    _, idx = jvox.voxel_downsample(jnp.asarray(x), m, key, mode="center")
    _, p_idx, p_comp, p_xyz = jvox.voxel_downsample_partition(
        jnp.asarray(x), m, key, mode="center")
    u, geom = jax_inputs(x, m, key)
    _, t_idx = voxel_downsample(torch.from_numpy(x), m, priority=u,
                                geometry=geom, mode="center")
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    _, tp_idx, tp_comp, tp_xyz = voxel_downsample_partition(
        torch.from_numpy(x), m, priority=u, geometry=geom, mode="center")
    np.testing.assert_array_equal(tp_idx.numpy(), np.asarray(p_idx))
    np.testing.assert_array_equal(tp_comp.numpy(), np.asarray(p_comp))
    np.testing.assert_array_equal(tp_xyz.numpy(), np.asarray(p_xyz))


def test_center_representative_is_nearest_point(rng):
    """Every voxel's representative is its point nearest the center: with
    more voxels than the target, only representatives are selected, and
    none is farther from its center than another point of its voxel."""
    from pointcloud_style_transfer_torch.ops.voxel import (_representatives,
                                                           voxel_geometry)
    x = torch.from_numpy(cloud(rng, 1, 600, 1.0)[0])
    mn, size = voxel_geometry(x, 64)
    reps = _representatives(x, mn, size, "center")
    vox = torch.floor((x - mn) / size).to(torch.int32)
    d = ((x - (mn + (vox.float() + 0.5) * size)) ** 2).sum(-1)
    keys = [tuple(v) for v in vox.tolist()]
    assert len(set(keys)) == len(reps)
    for r in reps.tolist():
        same = [i for i, k in enumerate(keys) if k == keys[r]]
        assert d[r] == d[same].min()
        assert r == min(i for i in same if d[i] == d[r])


def test_small_cloud_and_unknown_mode(rng):
    x = torch.from_numpy(cloud(rng, 2, 50, 1.0))
    ds, idx, comp = voxel_downsample_with_complement(x, 64, mode="center")
    assert ds is x and comp.shape == (2, 0)
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(50), (2, 1)))
    with pytest.raises(ValueError, match="unknown voxel downsample mode"):
        voxel_downsample(x, 16, mode="median")
