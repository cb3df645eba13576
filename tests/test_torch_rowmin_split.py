"""The row-min kernel's order of work (``csrc/rowmin.cu``), emulated on the
CPU in plain torch, against the plain version and the TPU kernel
(``pallas_min_sq_dist``, interpret mode).

The kernel gives each thread Q queries (a constant of the source, 4;
query block g holds 128 * Q queries; padding queries past Nq are scanned at
the origin and never written), splits the ref axis into S ascending slices
of ceil(M / S) refs (a constant of the source, 8), one a cluster rank
(ranks past M scan nothing), scans each slice in tiles
of 1,024 refs with a NaN-keeping minimum from 1e30, merges the ranks'
minima in rank 0 with the same minimum and clamps at 0 keeping NaN. The
emulation runs that order; its values are identical to ``rowmin_plain``
(and, with XLA's CPU distance form, to the JAX package's kernel) for every
S and for the source's Q and the others the sweep builds: a NaN in one
rank's slice only, a NaN query, Nq not a multiple of Q x 128, a row whose
minimum stays at the 1e30 cap, M smaller than S, and the source's S and Q
at the compare CLI's and the Chamfer loss's shapes.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels import rowmin_plain
from pointcloud_style_transfer_torch.ops.kernels._common import (
    pairwise_sq_dist, source_define)
from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import \
    pallas_min_sq_dist

from torch_parity import xla_cpu_distances, xla_cpu_sq_dist

THREADS, TILE = 128, 1024  # csrc/rowmin.cu's kThreads, kTile
SOURCE_S = source_define("rowmin", "PCST_ROWMIN_S")
SOURCE_Q = source_define("rowmin", "PCST_ROWMIN_Q")
SMS = 132  # streaming multiprocessors of an H100
# (S, Q): the source's first, then every cluster size with the source's Q,
# then other Q the sweep builds
PLANS = list(dict.fromkeys(
    [(SOURCE_S, SOURCE_Q)] + [(S, SOURCE_Q) for S in (1, 2, 4, 8)]
    + list(itertools.product((1, 8), (1, 2, 8)))))


def emulate(q, r, S, Q, dist=pairwise_sq_dist):
    """The kernel's split scan and merge -> [B, Nq] float32."""
    B, N, _ = q.shape
    M = r.shape[1]
    per_block = THREADS * Q
    blocks = -(-N // per_block)
    qp = torch.zeros((B, blocks * per_block, 3))  # padding queries at 0
    qp[:, :N] = q
    chunk = -(-M // S)
    out = torch.empty((B, N))
    for b in range(B):
        best = []
        for rank in range(S):
            lo = min(M, rank * chunk)
            hi = min(M, lo + chunk)
            m = torch.full((blocks * per_block,), 1e30)
            for base in range(lo, hi, TILE):
                d = dist(qp[b], r[b, base:min(base + TILE, hi)])
                # min.NaN ref by ref is the tile's NaN-keeping amin: a
                # minimum is exact in any order (up to the sign of a zero,
                # which the clamp and the comparisons do not tell apart)
                m = torch.minimum(m, d.amin(dim=1))
            best.append(m)
        merged = best[0]
        for m in best[1:]:  # rank 0 reads ranks 1..S-1 in order
            merged = torch.minimum(merged, m)
        # thread t of block g holds queries g * 128 Q + u * 128 + t
        held = merged.view(blocks, Q, THREADS)
        written = torch.maximum(held, torch.tensor(0.0)).reshape(-1)[:N]
        out[b] = written
    return out


def clouds(rng, b, n, m):
    """Refs with exact duplicates, queries on refs (zero distances)."""
    r = rng.standard_normal((b, m, 3)).astype(np.float32)
    q = rng.standard_normal((b, n, 3)).astype(np.float32)
    r[:, rng.choice(m, m // 5, replace=False)] = r[:, rng.choice(m, m // 5)]
    q[:, : n // 4] = r[:, rng.choice(m, n // 4)]
    return q, r


def same(got, want):
    """Identical values, NaN where the other has NaN."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                              want[~nan])


def check(q, r, plans=PLANS):
    """Every plan's emulation == the plain version; with XLA's CPU
    distances the plain version and the emulation == the TPU kernel."""
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    want = rowmin_plain(qt, rt)
    for S, Q in plans:
        assert same(emulate(qt, rt, S, Q), want), (S, Q)
    jax_out = torch.from_numpy(np.array(pallas_min_sq_dist(
        jnp.asarray(q), jnp.asarray(r), True)))
    with xla_cpu_distances():
        assert same(rowmin_plain(qt, rt), jax_out)
    S, Q = plans[0]
    assert same(emulate(qt, rt, S, Q, xla_cpu_sq_dist), jax_out)
    return want


@pytest.mark.parametrize("rank", [0, 2, 3])
def test_nan_in_one_rank_slice_only(rng, rank):
    """A NaN ref inside rank ``rank``'s slice of S = 4 makes every row NaN,
    whichever rank scanned it; the other cloud stays finite."""
    q, r = clouds(rng, 2, 300, 2000)
    chunk = -(-2000 // 4)
    r[0, rank * chunk + 17, 1] = np.copysign(np.float32(np.nan), -1.0)
    want = check(q, r)
    assert torch.isnan(want[0]).all() and torch.isfinite(want[1]).all()


def test_nan_query_keeps_its_row_only(rng):
    q, r = clouds(rng, 1, 260, 1500)
    q[0, 5, 0] = np.nan
    q[0, 259, 2] = np.copysign(np.float32(np.nan), -1.0)
    want = check(q, r)
    assert torch.isnan(want).sum().item() == 2


@pytest.mark.parametrize("n", [1, 127, 129, 300, 513])
def test_nq_not_a_multiple_of_the_query_block(rng, n):
    q, r = clouds(rng, 1, n, 1100)
    want = check(q, r)
    assert (want[0, : n // 4] == 0).all()


def test_row_at_the_cap(rng):
    """Distances above 1e30 (far refs, an infinite coordinate) leave the
    row at the scan's initial 1e30."""
    q, r = clouds(rng, 2, 200, 1200)
    q[0, 3] = [1e16, 0.0, 0.0]     # every distance ~1e32
    r[1] = 1e16                    # the whole cloud far away
    r[1, 5, 2] = np.inf
    want = check(q, r)
    assert want[0, 3].item() == np.float32(1e30)
    assert (want[1] == np.float32(1e30)).all()


@pytest.mark.parametrize("m", [1, 3, 7])
def test_fewer_refs_than_slices(rng, m):
    """M < S: ranks past the last ref scan nothing and merge 1e30."""
    q, r = clouds(rng, 2, 150, m)
    check(q, r)


@pytest.mark.parametrize("n", [120_000, 30_000])
def test_source_plan_at_the_compare_and_chamfer_shapes(rng, n):
    """The source's S and Q at 120,000 x 120,000 and 30,000 x 30,000: at
    least one block for every SM of the card (472 blocks of 512 queries at
    30,000), each rank's slice at least a tile of refs; run on a cloud cut
    to 3,000 points."""
    blocks = -(-n // (THREADS * SOURCE_Q)) * SOURCE_S
    assert blocks >= SMS and n // SOURCE_S >= TILE
    q, r = clouds(rng, 1, 3000, 3000)
    check(q, r, plans=[(SOURCE_S, SOURCE_Q)])


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_every_cluster_size_on_a_ragged_cloud(rng, S):
    """Each S the sweep builds, with M not a multiple of S and Nq not a
    multiple of the query block, over several clouds."""
    q, r = clouds(rng, 3, 700, 2 * TILE * S + S - 1)
    check(q, r, plans=[(S, SOURCE_Q), (S, 1)])
