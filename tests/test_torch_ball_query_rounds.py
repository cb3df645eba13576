"""The ball query kernel's order of work (``csrc/ball_query.cu``), emulated
on the CPU in plain torch, against the plain version and the TPU kernel
(``pallas_ball_query``, interpret mode).

The kernel gives one block of W warps to a center and takes the points in
ascending rounds of R = W * 32 * U: warp w takes the w-th run of 32 * U
points, U steps of 32; each hit's slot is count + the exclusive prefix of
the warps' hits + the hits of the warp's earlier steps + the lane prefix of
its ballot, written while below ns; the hit of slot 0 is the row's first;
the block stops after the round that fills ns slots; the empty slots take
the first index, or N for a row with no point inside. The emulation runs
that order for the source's (W, U) and others, and every case is held
identical to ``ball_query_plain`` and to the JAX package's kernel: no hit;
hits only in the last, partial round; exactly ns hits ending on a round or
a warp boundary; hits straddling warps; fewer points than ns; N not a
multiple of R; several clouds; NaN coordinates of both signs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels import ball_query_plain
from pointcloud_style_transfer_torch.ops.kernels._common import (
    pairwise_sq_dist, source_define)
from pointcloud_style_transfer_torch.ops.kernels.ball_query import \
    radius_sq_f32
from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import \
    pallas_ball_query

WARPS = source_define("ball_query", "PCST_BQ_WARPS")
UNROLL = source_define("ball_query", "PCST_BQ_UNROLL")
# (warps, unroll): the source's, and others the sweep may pick
PLANS = [(WARPS, UNROLL), (1, 1), (2, 3), (4, 2), (8, 8), (32, 1)]
RADIUS = 0.5


def emulate(radius, ns, xyz, new_xyz, warps, unroll):
    """The kernel's rounds for all centers at once -> (out [B, S, ns] int32,
    rounds each center ran [B, S])."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    span = 32 * unroll
    R = warps * span
    out = torch.full((B, S, ns), -1, dtype=torch.int32)
    rounds = torch.zeros((B, S), dtype=torch.int64)
    for b in range(B):
        inside = pairwise_sq_dist(new_xyz[b], xyz[b]) <= radius_sq_f32(radius)
        count = torch.zeros(S, dtype=torch.int64)
        first = torch.full((S,), N, dtype=torch.int64)
        live = torch.ones(S, dtype=torch.bool)
        for base in range(0, N, R):
            idx = torch.arange(base, base + R)
            hit = torch.zeros((S, R), dtype=torch.bool)
            hit[:, : min(R, N - base)] = inside[:, base:base + R]
            hit &= live[:, None]
            # [S, warp, step, lane]
            h = hit.view(S, warps, unroll, 32).long()
            step_hits = h.sum(3)
            warp_hits = step_hits.sum(2)
            warp_prefix = warp_hits.cumsum(1) - warp_hits
            step_prefix = step_hits.cumsum(2) - step_hits
            lane_prefix = h.cumsum(3) - h
            slot = (count[:, None, None, None] + warp_prefix[:, :, None, None]
                    + step_prefix[..., None] + lane_prefix).view(S, R)
            rows, cols = torch.nonzero(hit & (slot < ns), as_tuple=True)
            out[b, rows, slot[rows, cols]] = idx[cols].int()
            rows, cols = torch.nonzero(hit & (slot == 0), as_tuple=True)
            first[rows] = idx[cols]
            rounds[b] += live.long()
            count += warp_hits.sum(1)
            live &= count < ns
        for c in range(S):
            k = min(int(count[c]), ns)
            out[b, c, k:] = first[c]
    return out, rounds


def cloud(B, N, hits, seed=0):
    """Points inside the radius of the center at the origin at the indices
    of ``hits`` (a set, or a list per cloud), the others well outside; the
    center is the origin. Returns (xyz [B, N, 3], centers [B, 1, 3])."""
    rng = np.random.default_rng(seed)
    xyz = (rng.uniform(2.0, 4.0, (B, N, 3))
           * rng.choice([-1.0, 1.0], (B, N, 3))).astype(np.float32)
    for b in range(B):
        sel = sorted(hits[b] if isinstance(hits, list) else hits)
        xyz[b, sel] = rng.uniform(-0.2, 0.2, (len(sel), 3)).astype(np.float32)
    return xyz, np.zeros((B, 1, 3), np.float32)


def check(xyz, centers, ns, plans=PLANS):
    """Every plan's emulation == the plain version == the TPU kernel;
    returns the source plan's rounds."""
    xt, ct = torch.from_numpy(xyz), torch.from_numpy(centers)
    want = ball_query_plain(RADIUS, ns, xt, ct)
    jax_out = np.asarray(pallas_ball_query(RADIUS, ns, jnp.asarray(xyz),
                                           jnp.asarray(centers),
                                           interpret=True))
    np.testing.assert_array_equal(want.numpy(), jax_out)
    rounds = None
    for warps, unroll in plans:
        got, r = emulate(RADIUS, ns, xt, ct, warps, unroll)
        assert torch.equal(got, want), (warps, unroll)
        if (warps, unroll) == (WARPS, UNROLL):
            rounds = r
    return want, rounds


R = WARPS * 32 * UNROLL   # the source's round
SPAN = 32 * UNROLL        # the source's run of one warp


def test_source_constants():
    assert 1 <= WARPS <= 32 and UNROLL >= 1


def test_no_hit_stays_at_the_sentinel():
    N = 2 * R + 5
    xyz, c = cloud(1, N, set())
    want, rounds = check(xyz, c, 32)
    assert (want == N).all()
    assert rounds.item() == 3  # every round scanned


def test_hits_only_in_the_last_partial_round():
    N = 2 * R + 77
    hits = {2 * R + 3, 2 * R + 40, 2 * R + 76}
    xyz, c = cloud(1, N, hits)
    want, rounds = check(xyz, c, 8)
    assert want[0, 0].tolist() == sorted(hits) + [2 * R + 3] * 5
    assert rounds.item() == 3


@pytest.mark.parametrize("end", [R, SPAN, 2 * SPAN + 32])
def test_exactly_ns_hits_ending_on_a_boundary(end):
    """ns hits whose last sits just before a round, warp or step boundary:
    the row fills exactly there, and the block stops after that round."""
    ns = 32
    N = 3 * R
    hits = set(range(end - ns, end))
    xyz, c = cloud(1, N, hits)
    want, rounds = check(xyz, c, ns)
    assert want[0, 0].tolist() == sorted(hits)
    assert rounds.item() == -(-end // R)


@pytest.mark.parametrize("ns", [4, 16, 64])
def test_hits_straddling_warps(ns):
    N = 2 * R + 100
    hits = (set(range(SPAN - 6, SPAN + 9))
            | set(range(3 * SPAN - 1, 3 * SPAN + 1)))
    hits |= {R - 1, R, R + 1}
    hits = {h for h in hits if h < N}
    xyz, c = cloud(1, N, hits)
    want, _ = check(xyz, c, ns)
    got = sorted(hits)[:ns]
    assert want[0, 0, : len(got)].tolist() == got


def test_fewer_points_than_ns():
    N = 20
    xyz, c = cloud(1, N, {0, 7, 19})
    want, rounds = check(xyz, c, 64)
    assert want[0, 0].tolist() == [0, 7, 19] + [0] * 61
    assert rounds.item() == 1


@pytest.mark.parametrize("extra", [1, 33, R - 1])
def test_n_not_a_multiple_of_the_round(rng, extra):
    N = R + extra
    hits = set(rng.choice(N, 40, replace=False).tolist())
    xyz, c = cloud(1, N, hits, seed=extra)
    want, _ = check(xyz, c, 32)
    assert want[0, 0].tolist() == sorted(hits)[:32]


def test_several_clouds_and_centers(rng):
    """B = 3 random clouds, centers on points and off them: full rows,
    backfilled rows and empty rows, each cloud its own."""
    B, N, S = 3, R + 300, 40
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    dup = rng.choice(N, N // 5, replace=False)
    xyz[:, dup] = xyz[:, rng.choice(N, N // 5)]
    centers = np.concatenate(
        [xyz[:, : S // 2], rng.standard_normal((B, S - S // 2, 3)).astype(
            np.float32) * 3], axis=1)
    want, _ = check(xyz, centers, 16)
    assert (want == N).all(-1).any()  # an empty row
    backfilled = (want[..., 1:] == want[..., :1]).all(-1) & (want[..., 0] < N)
    assert backfilled.any()
    assert (want[..., -1] != want[..., 0]).any()  # a full row


def test_nan_coordinates_of_both_signs():
    """A NaN distance is never inside, whatever the NaN's sign bit."""
    N = R + 50
    hits = set(range(0, N, 7))
    xyz, c = cloud(2, N, hits)
    neg = np.copysign(np.float32(np.nan), np.float32(-1.0))
    xyz[0, 7, 0] = np.nan
    xyz[0, 14, 2] = neg
    xyz[1, 21, 1] = neg
    xyz[1, R + 2, 0] = np.nan
    assert np.signbit(xyz[0, 14, 2]) and not np.signbit(xyz[0, 7, 0])
    want, _ = check(xyz, c, 48)
    assert 7 not in want[0, 0].tolist() and 14 not in want[0, 0].tolist()
    assert 21 not in want[1, 0].tolist()
    assert want[0, 0, 0].item() == 0 and want[0, 0, 1].item() == 21


def test_nan_center_gives_an_empty_row():
    N = 300
    xyz, c = cloud(1, N, set(range(10)))
    c[0, 0, 1] = np.copysign(np.float32(np.nan), np.float32(-1.0))
    want, _ = check(xyz, c, 8)
    assert (want == N).all()
