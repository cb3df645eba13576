"""FPS: the kernel's plain PyTorch version vs the TPU kernel
(``pallas_farthest_point_sample``, interpret mode) from the same start
indices. Indices identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import farthest_point_sample
from pointcloud_style_transfer_torch.ops.kernels import (
    farthest_point_sample_kernel, fps_plain)
from pointcloud_style_transfer_tpu.ops.pallas.fps import \
    pallas_farthest_point_sample


@pytest.mark.parametrize("b,n,npoint,dups", [
    (2, 300, 24, False),
    (1, 1024, 64, False),  # N = 8 * 128: no padding in the TPU layout
    (2, 500, 40, True),    # exact duplicates: tied maxima, lowest index wins
    (1, 20, 30, False),    # npoint > N: repeats once every point is taken
])
def test_fps_plain_matches_pallas(rng, b, n, npoint, dups):
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    if dups:
        xyz[:, rng.choice(n, n // 3, replace=False)] = \
            xyz[:, rng.choice(n, n // 3)]
        xyz = np.round(xyz * 4) / 4  # lattice: many equal distances
    start = rng.integers(0, n, b).astype(np.int32)
    want = pallas_farthest_point_sample(
        jnp.asarray(xyz), npoint, jax.random.PRNGKey(0), interpret=True,
        start=jnp.asarray(start))
    got = fps_plain(torch.from_numpy(xyz), npoint, torch.from_numpy(start))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 0].numpy(), start)


def test_farthest_point_sample_draws_start_from_generator(rng):
    xyz = torch.from_numpy(rng.standard_normal((3, 200, 3)).astype(np.float32))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = farthest_point_sample(xyz, 16, generator=g1)
    b = farthest_point_sample(xyz, 16, generator=g2)
    assert a.shape == (3, 16) and torch.equal(a, b)
    start = torch.tensor([3, 7, 11])
    c = farthest_point_sample(xyz, 16, start=start)
    assert torch.equal(c[:, 0], start.int())
    assert torch.equal(c, farthest_point_sample(xyz, 16, start=start,
                                                use_kernel=False))


def test_fps_past_the_register_cap_matches_pallas(rng):
    """70,000 points, past the CUDA kernel's register-resident 65,536 (the
    streaming kernel's range): the wrapper's CPU path against the TPU
    kernel, which takes any N. Lattice points make every distance exact in
    both arithmetics and tie many of them."""
    n = 70000
    xyz = np.round(rng.standard_normal((2, n, 3)) * 8).astype(np.float32) / 8
    start = rng.integers(0, n, 2).astype(np.int32)
    want = pallas_farthest_point_sample(
        jnp.asarray(xyz), 8, jax.random.PRNGKey(0), interpret=True,
        start=jnp.asarray(start))
    got = farthest_point_sample_kernel(torch.from_numpy(xyz), 8,
                                       torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
