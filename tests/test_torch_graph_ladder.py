"""The kd-grid's fallback ladder on the device: the port vs the JAX package
(Pallas kernels in interpret mode) at every tier of ``_fallback_caps``.

The port keeps the unsafe count on the device, compacts the rows to
recompute in ascending order into a buffer of static size and runs one
brute-force launch that reads its row count from device memory
(``_patch_rows``, ``_patched``); the reference picks the tier with
``lax.switch`` over buffers of each cap. The tiers are set by
``fallback_cap`` around each input's own unsafe count: none unsafe, the
count inside the first cap, between two caps, and above the last (every row
brute-forced); at B = 3 the flat-batched ladder with clouds whose own counts
lie in different tiers, the shared tier following the largest.

The port's plain kernels compute distances as XLA's CPU backend does
(``xla_cpu_distances``), so neighbour ids, distances and layout ids must be
identical; interpolated values are held to rtol 1e-6 and atol 1e-6 * max|v|
(the bars of ``tests/test_torch_grid_knn.py``: the weighted sums run in
another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import grid_knn as P

from torch_parity import xla_cpu_distances

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

GRID = dict(grid_shape=(4, 4, 5))
# a grid whose +-1 halo covers every slab and row: no row is ever unsafe
COVERING = dict(grid_shape=(2, 2, 2))
TIERS = ("none", "first", "between", "all_brute")


def assert_values_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def clustered(seed, m=800, n_cluster=1000, n_bg=1048, C=3):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((m, 3)).astype(np.float32)
    r[rng.choice(m, m // 10, replace=False)] = r[rng.choice(m, m // 10)]
    cluster = rng.standard_normal((n_cluster, 3)).astype(np.float32) * 0.01
    bg = rng.standard_normal((n_bg, 3)).astype(np.float32) * 3
    q = np.concatenate([cluster + 0.001, bg])
    q[::9] = r[rng.choice(m, len(q[::9]))]
    v = rng.standard_normal((m, C)).astype(np.float32)
    return q, r, v


def tier_of(n_unsafe: int, fallback_cap: int, n_rows: int) -> str:
    caps = P._fallback_caps(fallback_cap, n_rows)
    if n_unsafe == 0:
        return "none"
    if n_unsafe > caps[-1]:
        return "all_brute"
    return "first" if n_unsafe <= caps[0] else "between"


def cap_for(tier: str, n_unsafe: int) -> int:
    """A ``fallback_cap`` whose ladder puts ``n_unsafe`` rows in ``tier``:
    the first cap (cap / 2) just holds them; or the first cap is below them
    and the second (cap) holds them; or the last is below them."""
    return {"none": 4096, "first": 2 * n_unsafe + 2, "between": n_unsafe,
            "all_brute": 16}[tier]


def unsafe_count(run) -> int:
    """The one unsafe count ``run`` records (a single-cloud pass)."""
    P.UNSAFE_COUNTS.clear()
    with xla_cpu_distances():
        out = run()
    (n,) = P.unsafe_counts()
    return n, out


@pytest.mark.parametrize("tier", TIERS)
def test_layout_ladder_every_tier(tier):
    """``grid_knn_interpolate_layout`` (JAX ``_grid_interp_single_layout``):
    layout ids identical, values within the bars, at each tier."""
    q, r, v = clustered(1)
    grid = COVERING if tier == "none" else GRID
    tq, tr, tv = (torch.from_numpy(a) for a in (q, r, v))
    n0, _ = unsafe_count(lambda: P.grid_knn_interpolate_layout(
        tq, tr, tv, k=3, **grid))
    cap = cap_for(tier, n0)
    n, (v_p, qid_p) = unsafe_count(lambda: P.grid_knn_interpolate_layout(
        tq, tr, tv, k=3, fallback_cap=cap, **grid))
    assert n == n0 and tier_of(n, cap, len(q)) == tier
    v_j, qid_j = J.grid_knn_interpolate_layout(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(v), k=3,
        fallback_cap=cap, interpret=True, **grid)
    np.testing.assert_array_equal(qid_p.numpy(), np.asarray(qid_j))
    real = qid_p.numpy() < len(q)
    assert_values_close(v_p.numpy()[real], np.asarray(v_j)[real])


@pytest.mark.parametrize("tier", TIERS)
def test_knn_ladder_every_tier(tier):
    """``grid_knn`` (JAX ``_grid_knn_single``): neighbour ids and distances
    identical at each tier."""
    q, r, _ = clustered(2)
    grid = COVERING if tier == "none" else GRID
    tq, tr = torch.from_numpy(q)[None], torch.from_numpy(r)[None]
    n0, _ = unsafe_count(lambda: P.grid_knn(tq, tr, k=3, **grid))
    cap = cap_for(tier, n0)
    n, (d_p, i_p) = unsafe_count(lambda: P.grid_knn(
        tq, tr, k=3, fallback_cap=cap, **grid))
    assert n == n0 and tier_of(n, cap, len(q)) == tier
    d_j, i_j = J.grid_knn(jnp.asarray(q)[None], jnp.asarray(r)[None], k=3,
                          fallback_cap=cap, interpret=True, **grid)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("tier", TIERS)
def test_query_order_ladder_every_tier(tier):
    """``grid_knn_interpolate`` of one cloud (JAX ``_grid_interp_single``,
    the ladder in query order): values within the bars at each tier."""
    q, r, v = clustered(3, C=4)
    grid = COVERING if tier == "none" else GRID
    tq, tr, tv = (torch.from_numpy(a)[None] for a in (q, r, v))
    n0, _ = unsafe_count(lambda: P.grid_knn_interpolate(tq, tr, tv, k=3,
                                                        **grid))
    cap = cap_for(tier, n0)
    n, got = unsafe_count(lambda: P.grid_knn_interpolate(
        tq, tr, tv, k=3, fallback_cap=cap, **grid))
    assert n == n0 and tier_of(n, cap, len(q)) == tier
    want = J.grid_knn_interpolate(jnp.asarray(q)[None], jnp.asarray(r)[None],
                                  jnp.asarray(v)[None], k=3, fallback_cap=cap,
                                  interpret=True, **grid)
    assert_values_close(got.numpy(), want)


def mixed_clouds(seed, m=640, nq=2048):
    """Three clouds of one shape whose unsafe counts differ widely: a
    clustered one, a half-clustered one and a smooth one."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((3, m, 3)).astype(np.float32)
    qs = []
    for n_cluster in (1200, 500, 0):
        cluster = rng.standard_normal((n_cluster, 3)).astype(np.float32)
        bg = rng.standard_normal((nq - n_cluster, 3)).astype(np.float32)
        qs.append(np.concatenate([cluster * 0.01 + 0.001, bg * 3 if n_cluster
                                  else bg]))
    v = rng.standard_normal((3, m, 2)).astype(np.float32)
    return np.stack(qs), r, v


@pytest.mark.parametrize("tier", ("first", "between", "all_brute"))
def test_batched_ladder_mixed_tiers(tier):
    """The flat-batched ladder at B = 3 (JAX ``_grid_interp_batched_layout``)
    with clouds whose own counts lie in different tiers (between caps and
    all-brute; with the first cap every cloud lies in it): the shared tier
    follows the largest count, each cloud's rows brute-forced against its
    own refs; layout ids identical, values within the bars."""
    q, r, v = mixed_clouds(4)
    tq, tr, tv = (torch.from_numpy(a) for a in (q, r, v))
    P.UNSAFE_COUNTS.clear()
    with xla_cpu_distances():
        P.grid_knn_interpolate_layout_batched(tq, tr, tv, k=3, **GRID)
    counts = P.unsafe_counts()
    assert len(counts) == 3 and len(set(counts)) == 3, counts
    cap = cap_for(tier, max(counts))
    own = {tier_of(c, cap, q.shape[1]) for c in counts}
    # below the first cap every cloud is in it: the tiers mix above
    assert tier_of(max(counts), cap, q.shape[1]) == tier
    assert len(own) > 1 or tier == "first"
    with xla_cpu_distances():
        v_p, qid_p = P.grid_knn_interpolate_layout_batched(
            tq, tr, tv, k=3, fallback_cap=cap, **GRID)
    assert P.unsafe_counts()[-3:] == counts
    v_j, qid_j = J.grid_knn_interpolate_layout_batched(
        *(jnp.asarray(a) for a in (q, r, v)), k=3, fallback_cap=cap,
        interpret=True, **GRID)
    np.testing.assert_array_equal(qid_p.numpy(), np.asarray(qid_j))
    real = qid_p.numpy() < q.shape[0] * q.shape[1]
    assert_values_close(v_p.numpy()[real], np.asarray(v_j)[real])


@pytest.mark.parametrize("all_brute", (False, True))
@pytest.mark.parametrize("seed", (5, 6))
def test_patch_rows_is_the_reference_compaction(seed, all_brute):
    """``_patch_rows``'s cumsum scatter orders the rows as the reference's
    one sort of ``where(unsafe, iota, n)`` does, per cloud; the all-brute
    tier takes every row in order; slots past the count hold n."""
    rng = np.random.default_rng(seed)
    unsafe = rng.random((3, 500)) < np.array([[0.0], [0.05], [0.6]])
    ids, count = P._patch_rows(torch.from_numpy(unsafe),
                               torch.tensor(all_brute))
    assert ids.dtype == torch.int32 and count.dtype == torch.int32
    for b in range(3):
        take = np.ones(500, bool) if all_brute else unsafe[b]
        want = np.sort(np.where(take, np.arange(500), 500))
        np.testing.assert_array_equal(ids[b].numpy(), want)
        assert count[b] == take.sum()
