"""The slot-run kNN kernels' plain PyTorch versions (``grid_topk_plain``,
``grid_interp_plain``) vs the TPU kernels (``grid_topk_resident``,
``grid_interp_resident``, interpret mode) on the same slot tables.

Tables are random: three runs per tile inside disjoint 128-aligned windows,
with empty runs, runs shorter than k, exact duplicate refs and queries on
refs. With the port's distances switched to the arithmetic of XLA's CPU
backend (``xla_cpu_distances``): d bit-identical on every row (a slot no
candidate fills holds 1e30 in both), sorted positions identical on rows
whose k-th d < 1e29, interpolated values within rtol 1e-6 and
atol 1e-6 * max|v| (the TPU kernel sums over its full masked width in
another order). With the port's own arithmetic the positions are identical
too and d within 3e-7 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels import (
    grid_interp, grid_interp_plain, grid_topk, grid_topk_plain)
from pointcloud_style_transfer_torch.ops.kernels import grid as grid_mod
from pointcloud_style_transfer_tpu.ops.pallas.grid_fused import (
    grid_interp_resident, grid_topk_resident)

from torch_parity import xla_cpu_distances

LANE, BPS, TQ = 128, 2, 128


def slot_inputs(rng, T, S, n_blocks, C=3):
    """Queries [T*TQ, 3], sorted refs [n_blocks*128, 3], values, and slot
    tables stb/st/en [T, S] whose runs lie in disjoint windows of BPS
    blocks; the last tile has no candidate, the one before it one or two."""
    M_pad = n_blocks * LANE
    refs = (rng.standard_normal((M_pad, 3))).astype(np.float32)
    dup = rng.choice(M_pad, M_pad // 8, replace=False)
    refs[dup] = refs[rng.choice(M_pad, M_pad // 8)]
    q = (rng.standard_normal((T * TQ, 3))).astype(np.float32)
    q[::7] = refs[rng.choice(M_pad, len(q[::7]))]
    vals = rng.standard_normal((M_pad, C)).astype(np.float32)
    stb = np.zeros((T, S), np.int32)
    st = np.zeros((T, S), np.int32)
    en = np.zeros((T, S), np.int32)
    for t in range(T):
        windows = rng.choice(n_blocks // BPS, S, replace=False) * BPS
        for s, w in enumerate(windows):
            lo = w * LANE + int(rng.integers(0, LANE))
            hi = lo + int(rng.choice([0, 1, 2, int(rng.integers(3, 150)),
                                      int(rng.integers(150, 250))]))
            stb[t, s], st[t, s] = w, lo
            en[t, s] = min(hi, (w + BPS) * LANE)
    en[-1] = st[-1]  # a tile without candidates
    en[-2] = st[-2] + np.arange(S) % 2  # a tile with fewer than k
    return q, refs, vals, stb, st, en


def positions_equal(i_p, i_j, d_j):
    full = d_j[:, -1] < 1e29
    assert full.sum() > 0 and (~full).sum() > 0
    np.testing.assert_array_equal(i_p[full], i_j[full])


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_grid_topk_plain_matches_pallas(rng, k):
    q, refs, _, stb, st, en = slot_inputs(rng, 6, 3, 12)
    d_j, i_j = (np.asarray(a) for a in grid_topk_resident(
        jnp.asarray(q), jnp.asarray(refs), jnp.asarray(stb), jnp.asarray(st),
        jnp.asarray(en), k=k, tq=TQ, blocks_per_slot=BPS, interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(refs),
            torch.from_numpy(st), torch.from_numpy(en), k)
    with xla_cpu_distances():
        d_p, i_p = grid_topk_plain(*args)
    assert d_p.dtype == torch.float32 and i_p.dtype == torch.int32
    np.testing.assert_array_equal(d_p.numpy(), d_j)
    positions_equal(i_p.numpy(), i_j, d_j)
    assert i_p.min() >= 0 and i_p.max() < refs.shape[0]

    d_n, i_n = grid_topk(*args)  # CPU tensors: the plain version
    positions_equal(i_n.numpy(), i_j, d_j)
    np.testing.assert_allclose(d_n.numpy(), d_j, rtol=3e-7, atol=0)


@pytest.mark.parametrize("k,C", [(3, 3), (2, 5)])
def test_grid_interp_plain_matches_pallas(rng, k, C):
    q, refs, vals, stb, st, en = slot_inputs(rng, 6, 3, 12, C)
    v_j, d_j = (np.asarray(a) for a in grid_interp_resident(
        jnp.asarray(q), jnp.asarray(refs), jnp.asarray(vals),
        jnp.asarray(stb), jnp.asarray(st), jnp.asarray(en), k=k, tq=TQ,
        blocks_per_slot=BPS, interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(refs),
            torch.from_numpy(vals), torch.from_numpy(st),
            torch.from_numpy(en), k)
    with xla_cpu_distances():
        v_p, d_p = grid_interp_plain(*args)
    np.testing.assert_array_equal(d_p.numpy(), d_j)
    full = d_j[:, -1] < 1e29
    assert np.isfinite(v_p.numpy()).all()
    np.testing.assert_allclose(v_p.numpy()[full], v_j[full], rtol=1e-6,
                               atol=1e-6 * np.abs(v_j[full]).max())

    v_n, d_n = grid_interp(*args)
    np.testing.assert_allclose(d_n.numpy(), d_j, rtol=3e-7, atol=0)
    np.testing.assert_allclose(v_n.numpy()[full], v_j[full], rtol=1e-6,
                               atol=1e-6 * np.abs(v_j[full]).max())


def test_grid_plain_chunked_equals_unchunked(rng, monkeypatch):
    q, refs, vals, _, st, en = slot_inputs(rng, 6, 3, 12)
    args = (torch.from_numpy(q), torch.from_numpy(refs),
            torch.from_numpy(vals), torch.from_numpy(st),
            torch.from_numpy(en), 3)
    want = grid_interp_plain(*args)
    monkeypatch.setattr(grid_mod, "_CHUNK_ELEMS", 1)  # one tile a chunk
    got = grid_interp_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_grid_plain_no_candidates(rng):
    """Tiles whose runs are all empty: every slot (1e30, position 0)."""
    q, refs, _, _, st, _ = slot_inputs(rng, 2, 3, 6)
    d, i = grid_topk_plain(torch.from_numpy(q), torch.from_numpy(refs),
                           torch.from_numpy(st), torch.from_numpy(st), 3)
    assert (d == 1e30).all() and (i == 0).all()
