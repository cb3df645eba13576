"""Ball query: the kernel's plain PyTorch version vs the TPU kernel
(``pallas_ball_query``, interpret mode), both of its nsample branches, with
empty rows (sentinel N) and backfilled slots. Indices identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import query_ball_point
from pointcloud_style_transfer_torch.ops.kernels import ball_query_plain
from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import \
    pallas_ball_query


@pytest.mark.parametrize("n,s,radius,ns", [
    (700, 50, 0.8, 8),     # nsample <= 32 branch, rows mostly full
    (600, 40, 0.6, 40),    # nsample > 32 branch, many rows backfilled
    (300, 30, 0.05, 4),    # tiny radius: empty rows and self-only rows
    (20, 10, 1.5, 32),     # fewer points than nsample
])
def test_ball_query_plain_matches_pallas(rng, n, s, radius, ns):
    xyz = rng.standard_normal((2, n, 3)).astype(np.float32)
    xyz[:, rng.choice(n, n // 5, replace=False)] = xyz[:, rng.choice(n, n // 5)]
    centers = np.concatenate(
        [xyz[:, : s // 2],  # on points: at least one hit
         rng.standard_normal((2, s - s // 2, 3)).astype(np.float32) * 3],
        axis=1)
    want = np.asarray(pallas_ball_query(radius, ns, jnp.asarray(xyz),
                                        jnp.asarray(centers), interpret=True))
    got = ball_query_plain(radius, ns, torch.from_numpy(xyz),
                           torch.from_numpy(centers))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if radius == 0.05:  # the case is meant to cover both edge rows
        assert (want == n).all(axis=-1).any()  # an empty row stays at N
        assert ((want[..., 1:] == want[..., :1]).all(axis=-1)
                & (want[..., 0] < n)).any()  # a fully backfilled row


def test_ball_query_radius_boundary(rng):
    """Points exactly at the radius are inside (d <= float32(r*r))."""
    xyz = np.zeros((1, 6, 3), np.float32)
    xyz[0, :, 0] = [0.0, 0.5, 0.25, 0.5000001, 0.4999999, 0.75]
    centers = np.zeros((1, 1, 3), np.float32)
    want = np.asarray(pallas_ball_query(0.5, 4, jnp.asarray(xyz),
                                        jnp.asarray(centers), interpret=True))
    got = query_ball_point(0.5, 4, torch.from_numpy(xyz),
                           torch.from_numpy(centers))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].tolist() == [0, 1, 2, 4]
