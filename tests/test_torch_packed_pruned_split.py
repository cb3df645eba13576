"""The packed-key kNN kernels' and the pruned pass kernel's order of work
(``csrc/knn_packed.cu::knn_f32packed_kernel`` and ``knn_packed_kernel``,
``csrc/knn_pruned.cu::knn_pruned_pass_kernel``), emulated on the CPU in
plain torch step by step, against their plain versions
(``knn_f32packed_keys_plain``, ``knn_intpacked_keys_plain``,
``knn_pruned_pass_plain``; the JAX parity of those is
``test_torch_knn_packed.py``, ``test_torch_knn_pruned.py`` and
``test_torch_large_k.py``).

f32-packed: each thread holds one query (query block g holds 128 queries,
padding queries past N are scanned at the origin and never written); rank r
of a cluster of S scans the r-th slice of ceil(M / S)
refs in tiles of 1,024, eight refs at a time, trying the exact inserts (the
key, the NaN refusal, the unsigned '<') only when the smallest of the eight
float distances is below the threshold derived from the k-th key W,
``float((W & ~0x7FFF) + 0x8000 - 0x00800000)``; rank 0 inserts the other
ranks' keys (in any order: keys are unique), then the padding refs. The raw
keys are identical to the plain version's for S in {1, 2, 4, 8}, with
duplicates, zero distances, padding refs, k > M and NaN coordinates of both
signs; the threshold never refuses a key that the exact test takes.

Int-packed: the same scan and merge with the key ``((bits(d) >>> 16) <<
idx_bits) | index`` compared as signed, from 2^30, and the filter on the
distances' bits as unsigned integers against ``((W >> idx_bits) + 1) <<
16``, saturated at 0xFFFFFFFF. The raw keys are identical to the plain
version's for every S and idx_bits 1 to 15, with infinite distances (whose
keys lie below the start key and are taken while fewer than k other refs
are left), k > M and NaN of both signs; the bound is tight at every bucket
edge, sets the sign bit at the start key with idx_bits = 15 and passes 32
bits below; a bound one bucket tighter, or a float threshold, gives other
keys.

Pruned pass: a cluster of S (``PCST_PRUNED_S``) serves 128 queries of a
query tile; rank r takes the row's unskipped tiles of ordinal [r c, (r+1) c),
c = ceil(n / S), scans each in chunks of ``PCST_PRUNED_CHUNK`` refs (a warp
of 32 queries skips a chunk when none is nearer the chunk's bounding box
than its k-th distance), eight refs per insert test against the k-th
distance; rank 0 starts from (d_init, i_init), the others from k copies of
(d_init[k-1], 0); rank 0 merges their lists in rank order, each in list
order, on strict '<'; the clusters take the query tiles with the most
unskipped tiles first. (d, i) are identical to the plain version's for S in
{1, 2, 4, 8}, on ties between refs and between refs and d_init, rows with
every tile skipped, rows with fewer unskipped tiles than S, and NaN refs of
both signs; the box's distance is never above a ref's.
"""

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels import (
    knn_f32packed_keys_plain, knn_intpacked_keys_plain, knn_pruned_pass_plain)
from pointcloud_style_transfer_torch.ops.kernels._common import (
    pairwise_sq_dist, source_define)
from pointcloud_style_transfer_torch.ops.kernels.knn import knn_topk_plan
from pointcloud_style_transfer_torch.ops.kernels.knn_packed import \
    packed_idx_bits

THREADS, TILE, UNROLL = 128, 1024, 8  # the kernels' constants
CHUNK = source_define("knn_pruned", "PCST_PRUNED_CHUNK")
START = 0x7149F2CA  # bits of 1e30f: the f32-packed start key
FAR = 1e15  # the padding refs' coordinate
SOURCE_S = source_define("knn_pruned", "PCST_PRUNED_S")
SIZES = (1, 2, 4, 8)  # every cluster size
NEG_NAN = np.copysign(np.float32(np.nan), np.float32(-1.0))


def fmin8(g):
    """fminf over a group of eight, left to right (a NaN is dropped)."""
    lowest = g[:, 0]
    for v in range(1, g.shape[1]):
        lowest = torch.fmin(lowest, g[:, v])
    return lowest


def sorted_insert(keys, vals, key, val, take):
    """The kernels' sorted insert on strict '<' against the k-th entry, on
    the rows ``take`` allows; ``vals`` follow ``keys`` (None: keys only)."""
    take = take & (key < keys[:, -1])  # a NaN never passes
    if not take.any():
        return keys, vals
    keys = keys.clone()
    keys[take, -1] = key[take]
    if vals is not None:
        vals = vals.clone()
        vals[take, -1] = val[take]
    for t in range(keys.shape[1] - 1, 0, -1):
        swap = keys[:, t] < keys[:, t - 1]
        keys[swap, t], keys[swap, t - 1] = keys[swap, t - 1], keys[swap, t]
        if vals is not None:
            vals[swap, t], vals[swap, t - 1] = (vals[swap, t - 1],
                                                vals[swap, t])
    return keys, vals


# ---- f32-packed ----

def key_bound(w):
    """The float below which a distance's key can be below w (int64)."""
    return ((w & ~0x7FFF) + 0x8000 - 0x00800000).to(torch.int32).view(
        torch.float32)


def f32_key(d, col):
    bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (((bits + 0x00800000) & 0xFFFFFFFF) & ~0x7FFF) | col


def offer(keys, bound, d, col, live):
    """A ref's exact insert: its key, the NaN refusal, the unsigned '<';
    the bound follows the k-th key."""
    take = live & ~torch.isnan(d) & (f32_key(d, col) < keys[:, -1])
    keys, _ = sorted_insert(keys, None, f32_key(d, col), None, take)
    return keys, torch.where(take, key_bound(keys[:, -1]), bound)


def scan_f32(qp, r, lo, hi, k):
    """One rank's scan of refs [lo, hi) -> its keys [R, k] (int64)."""
    keys = torch.full((qp.shape[0], k), START, dtype=torch.int64)
    bound = key_bound(keys[:, -1])
    for base in range(lo, hi, TILE):
        d = pairwise_sq_dist(qp, r[base:min(base + TILE, hi)])
        n = d.shape[1]
        for j in range(0, n - UNROLL + 1, UNROLL):
            g = d[:, j:j + UNROLL]
            passed = fmin8(g) < bound
            if not passed.any():
                continue
            for v in range(UNROLL):
                keys, bound = offer(keys, bound, g[:, v], base + j + v,
                                    passed & (g[:, v] < bound))
        for j in range(n - n % UNROLL, n):
            keys, bound = offer(keys, bound, d[:, j], base + j,
                                d[:, j] < bound)
    return keys


def emulate_f32packed(q, r, k, m_total, S, merge_order=None):
    """The kernel's per-rank scans, its merge through shared memory (key t
    of thread l at [t 128 + l]) in ``merge_order`` (rank order by default)
    and the padding refs -> int32 keys [B, N, k]."""
    B, N, _ = q.shape
    M = r.shape[1]
    qp = torch.zeros((-(-N // THREADS) * THREADS, 3))
    chunk = -(-M // S)
    out = torch.empty((B, N, k), dtype=torch.int32)
    for b in range(B):
        qp[:N] = q[b]
        lists = [scan_f32(qp, r[b], min(M, s * chunk),
                          min(M, min(M, s * chunk) + chunk), k)
                 for s in range(S)]
        keys = lists[0]
        every = torch.ones(qp.shape[0], dtype=torch.bool)
        for src in (merge_order or range(1, S)):
            for t in range(k):
                keys, _ = sorted_insert(keys, None, lists[src][:, t], None,
                                        every)
        bound = key_bound(keys[:, -1])
        d_pad = pairwise_sq_dist(qp, torch.full((1, 3), FAR))[:, 0]
        for t in range(min(k, m_total - M)):
            keys, bound = offer(keys, bound, d_pad, M + t, every)
        out[b] = keys[:N].to(torch.int32)  # taken keys are below 2^31
    return out


def tie_clouds(rng, b, n, m):
    """Lattice refs with exact duplicates over the whole ref axis (ties
    straddle the rank slices) and queries on refs (zero distances)."""
    r = np.round(rng.standard_normal((b, m, 3)) * 2) / 2
    r[:, rng.choice(m, m // 3, replace=False)] = r[:, rng.choice(m, m // 3)]
    q = np.round(rng.standard_normal((b, n, 3)) * 2) / 2 + 0.25
    q[:, : n // 3] = r[:, rng.choice(m, n // 3)]
    return q.astype(np.float32), r.astype(np.float32)


def check_f32packed(q, r, k, m_total, sizes=SIZES):
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    want = knn_f32packed_keys_plain(qt, rt, k, m_total).view(torch.int32)
    for S in sizes:
        assert torch.equal(emulate_f32packed(qt, rt, k, m_total, S), want), S
    return want


@pytest.mark.parametrize("b,n,m,k,m_total", [
    (1, 200, 1100, 3, 4096),   # a tile and a ragged one; padding refs
    (2, 130, 777, 16, 777),    # M not a multiple of S or 8; no padding
    (1, 90, 37, 9, 2048),      # slices shorter than k
    (1, 70, 5, 8, 4096),       # k > M: padding refs and start keys fill
    (1, 150, 300, 1, 512),     # the nearest only
])
def test_f32packed_split_scan_equals_plain(rng, b, n, m, k, m_total):
    q, r = tie_clouds(rng, b, n, m)
    want = check_f32packed(q, r, k, m_total)
    if m < k:  # the padding refs lie beyond 1e30: start keys fill
        assert (want[..., m:] == START).all()


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_f32packed_merge_in_any_rank_order(rng, order):
    """Keys are unique, so rank 0 may take the other ranks in any order."""
    q, r = tie_clouds(rng, 1, 160, 900)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    ranks = list(range(1, 8))
    merge = ranks[::-1] if order == "reversed" else list(rng.permutation(
        ranks))
    want = knn_f32packed_keys_plain(qt, rt, 5, 1024).view(torch.int32)
    got = emulate_f32packed(qt, rt, 5, 1024, 8, merge_order=merge)
    assert torch.equal(got, want)


def test_f32packed_nan_of_both_signs(rng):
    """NaN refs in rank 0's and the last rank's slices, a NaN query of each
    sign: never taken; the NaN rows keep the start keys, then the padding
    refs' keys where the padded count leaves some."""
    q, r = tie_clouds(rng, 1, 140, 400)
    r[0, 3, 1] = NEG_NAN
    r[0, 398, 0] = np.nan
    q[0, 7, 2] = NEG_NAN
    q[0, 139, 0] = np.nan
    want = check_f32packed(q, r, 4, 512)
    idx = want & 0x7FFF
    assert not ((idx == 3) | (idx == 398)).any()
    assert (want[0, [7, 139]] == START).all()


def test_f32packed_far_and_infinite_distances(rng):
    """Distances >= 2^127 and infinite ones have the key's sign bit set:
    never taken, nor let through by the threshold."""
    q, r = tie_clouds(rng, 1, 100, 300)
    r[0, :20] = 3e19  # squared distances ~2.7e39: infinite in float32
    q[0, :5] = -8e18  # squared distances ~1.9e38 >= 2^127, finite
    want = check_f32packed(q, r, 3, 300)
    assert not ((want & 0x7FFF) < 20)[0, 5:].any()


@pytest.mark.parametrize("n", [1, 127, 257, 513])
def test_f32packed_queries_past_the_block(rng, n):
    """N not a multiple of 128: the padding queries are scanned at the
    origin and never written."""
    q, r = tie_clouds(rng, 1, n, 260)
    check_f32packed(q, r, 3, 2048)


def test_f32packed_plan_of_the_two_callers():
    """The sampler's 90,000 rows take S = 2, the grid's patches S = 8:
    both x 30,000 refs padded within the 2^15 index budget."""
    assert knn_topk_plan(1, 90_000, 30_000) == 2
    assert knn_topk_plan(1, 2_500, 30_000) == 8
    assert SOURCE_S in SIZES


def _key_below_implies_under_threshold(d_bits, w, col):
    """key(d, col) < w (unsigned) -> d < thr(w), for non-negative d."""
    d = d_bits.view(np.float32)
    key = (((d_bits.astype(np.uint64) + 0x00800000) & 0xFFFFFFFF)
           & ~np.uint64(0x7FFF)) | col.astype(np.uint64)
    thr = key_bound(torch.from_numpy(w.astype(np.int64))).numpy()
    below = key < w.astype(np.uint64)
    assert np.isfinite(thr).all() and (thr > 0).all()
    assert (d[below] < thr[below]).all()
    return below, d < thr


def test_threshold_never_refuses_a_taken_key(rng):
    """Over random bit patterns of non-negative distances (zeros,
    denormals, the far and infinite ones included), random k-th keys from
    the smallest possible to the start key, and keys of the same coarse
    part as the distance's: the float filter passes every key the exact
    test takes, and not many more."""
    n = 2_000_000
    d_bits = rng.integers(0, 0x7F800001, n, dtype=np.uint32)
    d_bits[:1000] = 0
    d_bits[1000:2000] = rng.integers(1, 0x00800000, 1000)  # denormals
    w = rng.integers(0x00800000, START + 1, n, dtype=np.uint32)
    w[:10] = [0x00800000, START] * 5
    same = slice(2000, n // 2)  # W in the distance's own key bucket
    w[same] = ((((d_bits[same].astype(np.uint64) + 0x00800000) & 0xFFFFFFFF)
                & ~np.uint64(0x7FFF)) | rng.integers(
                    0, 0x8000, n // 2 - 2000).astype(np.uint64)
               ).clip(0x00800000, START).astype(np.uint32)
    col = rng.integers(0, 0x8000, n, dtype=np.uint32)
    below, passes = _key_below_implies_under_threshold(d_bits, w, col)
    random = slice(n // 2, n)
    assert below[random].sum() > n // 8
    assert passes[random].sum() - below[random].sum() < 1e-3 * n


@pytest.mark.parametrize("w", [0x00800000, 0x00807FFF, 0x00808000,
                               0x3F800000, 0x3F807ABC, START])
def test_threshold_is_tight_at_the_bucket_edge(w):
    """At the threshold's own bits T: a distance one ulp below it lies in
    W's bucket, passes the filter and has a key below W for every column
    below W's (none when W's column is 0); at T and above no key is below W
    and the filter refuses."""
    w = np.full(3 * 0x8000, w, np.uint32)
    thr_bits = key_bound(torch.from_numpy(w[:1].astype(np.int64))).view(
        torch.int32).item()
    d_bits = np.repeat(np.array([thr_bits - 1, thr_bits, thr_bits + 1],
                                np.uint32), 0x8000)
    col = np.tile(np.arange(0x8000, dtype=np.uint32), 3)
    below, passes = _key_below_implies_under_threshold(d_bits, w, col)
    assert passes[:0x8000].all()
    assert below[:0x8000].sum() == w[0] & 0x7FFF
    assert not below[0x8000:].any() and not passes[0x8000:].any()


# ---- int-packed ----

INT_START = 1 << 30  # the int-packed start key


def int_key(d, col, idx_bits):
    bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((bits >> 16) << idx_bits) | col


def int_bound(w, idx_bits, tighter=0):
    """The distance bits (unsigned, int64) at and above which no key is
    below w: ((w >> idx_bits) + 1) << 16, saturated at 32 bits;
    ``tighter`` buckets less (a wrong bound, for the tests' teeth)."""
    return (((w >> idx_bits) + 1 - tighter) << 16).clamp(max=0xFFFFFFFF)


def as_float_threshold(bound):
    """The bound read as a float32 threshold (a wrong filter: at and above
    +inf's bits it is +inf or NaN, which a strict '<' never passes)."""
    return bound.to(torch.int32).view(torch.float32)


def unsigned_bits(d):
    return d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def scan_int(qp, r, lo, hi, k, idx_bits, tighter=0, float_filter=False):
    """One rank's int-packed scan of refs [lo, hi) -> its keys [R, k]."""
    keys = torch.full((qp.shape[0], k), INT_START, dtype=torch.int64)

    def passes(d, bound):
        if float_filter:
            return d < as_float_threshold(bound)
        return unsigned_bits(d) < bound

    def offer_int(keys, bound, d, col, live):
        key = int_key(d, col, idx_bits)
        take = live & ~torch.isnan(d) & (key < keys[:, -1])
        keys, _ = sorted_insert(keys, None, key, None, take)
        return keys, torch.where(take, int_bound(keys[:, -1], idx_bits,
                                                 tighter), bound)

    bound = int_bound(keys[:, -1], idx_bits, tighter)
    for base in range(lo, hi, TILE):
        d = pairwise_sq_dist(qp, r[base:min(base + TILE, hi)])
        n = d.shape[1]
        for j in range(0, n - UNROLL + 1, UNROLL):
            g = d[:, j:j + UNROLL]
            lowest = unsigned_bits(g).amin(1)
            passed = (fmin8(g) < as_float_threshold(bound) if float_filter
                      else lowest < bound)
            if not passed.any():
                continue
            for v in range(UNROLL):
                keys, bound = offer_int(keys, bound, g[:, v], base + j + v,
                                        passed & passes(g[:, v], bound))
        for j in range(n - n % UNROLL, n):
            keys, bound = offer_int(keys, bound, d[:, j], base + j,
                                    passes(d[:, j], bound))
    return keys, offer_int


def emulate_intpacked(q, r, k, m_total, S, **wrong):
    """The int-packed kernel's per-rank scans, rank 0's merge in rank order
    and the padding refs -> int32 keys [B, N, k]; ``wrong`` takes
    ``scan_int``'s deliberately wrong filters."""
    B, N, _ = q.shape
    M = r.shape[1]
    idx_bits = packed_idx_bits(m_total)
    qp = torch.zeros((-(-N // THREADS) * THREADS, 3))
    chunk = -(-M // S)
    out = torch.empty((B, N, k), dtype=torch.int32)
    every = torch.ones(qp.shape[0], dtype=torch.bool)
    for b in range(B):
        qp[:N] = q[b]
        lists = []
        for s in range(S):
            lo = min(M, s * chunk)
            keys, offer_int = scan_int(qp, r[b], lo, min(M, lo + chunk), k,
                                       idx_bits, **wrong)
            lists.append(keys)
        keys = lists[0]
        for src in range(1, S):
            for t in range(k):
                keys, _ = sorted_insert(keys, None, lists[src][:, t], None,
                                        every)
        bound = int_bound(keys[:, -1], idx_bits)
        d_pad = pairwise_sq_dist(qp, torch.full((1, 3), FAR))[:, 0]
        for t in range(min(k, m_total - M)):
            keys, bound = offer_int(keys, bound, d_pad, M + t, every)
        out[b] = keys[:N].to(torch.int32)
    return out


def check_intpacked(q, r, k, m_total, sizes=SIZES):
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    want = knn_intpacked_keys_plain(qt, rt, k, m_total)
    for S in sizes:
        assert torch.equal(emulate_intpacked(qt, rt, k, m_total, S), want), S
    return want


@pytest.mark.parametrize("b,n,m,k,m_total", [
    (1, 200, 1100, 3, 2048),   # a tile and a ragged one; padding refs
    (2, 130, 777, 16, 777),    # M not a multiple of S or 8; idx_bits 10
    (1, 90, 37, 9, 64),        # slices shorter than k; idx_bits 6
    (1, 70, 5, 8, 8),          # k > M: padding refs fill; idx_bits 3
    (1, 150, 300, 1, 32768),   # the nearest only; idx_bits 15
    (1, 60, 2, 4, 2),          # k > M, no padding: start keys; idx_bits 1
])
def test_intpacked_split_scan_equals_plain(rng, b, n, m, k, m_total):
    q, r = tie_clouds(rng, b, n, m)
    want = check_intpacked(q, r, k, m_total)
    if m_total == m < k:  # neither refs nor padding fill: start keys
        assert (want[..., m:] == INT_START).all()


@pytest.mark.parametrize("idx_bits", range(1, 16))
def test_int_bound_is_tight_at_every_bucket_edge(rng, idx_bits):
    """For k-th keys W at bucket edges (the lowest and highest column of a
    coarse part, the start key): a distance whose bits lie one below the
    bound is in W's bucket and has a key below W for every column below
    W's; at the bound and above no key is below W. A bound one bucket
    tighter refuses a key the exact test takes (in a rank's ascending scan
    such a key cannot arrive after W, so only the keys show it). Where the
    bound passes 32 bits (the start key at idx_bits <= 14) every non-NaN
    distance passes."""
    cols = np.arange(1 << idx_bits, dtype=np.int64)
    coarse = rng.integers(1, 0x7F80, 20)
    ws = np.concatenate([(coarse << idx_bits), (coarse << idx_bits)
                         | ((1 << idx_bits) - 1), [INT_START]])
    for w in ws:
        bound = int(int_bound(torch.tensor([w]), idx_bits)[0])
        key = lambda bits: ((bits >> 16) << idx_bits) | cols  # noqa: E731
        if bound == 0xFFFFFFFF:  # saturated: every key is below 2^30 + 1
            assert w == INT_START and idx_bits <= 14
            assert (key(0x7F800000) < w).all()  # +inf's
            continue
        assert (key(bound - 1) < w).sum() == w & ((1 << idx_bits) - 1)
        assert not (key(bound) < w).any() and not (key(bound + 1) < w).any()
        tighter = int(int_bound(torch.tensor([w]), idx_bits, 1)[0])
        if w & ((1 << idx_bits) - 1):
            assert (key(tighter) < w).any()  # refused, yet taken exactly


def test_int_bound_at_the_start_key():
    """2^30 with idx_bits = 15 gives 0x80010000, which sets the sign bit
    (an int32 or float threshold reads it as negative); with idx_bits 14
    the bound is 2^32 + 2^16 and saturates."""
    start = torch.tensor([INT_START])
    assert int(int_bound(start, 15)[0]) == 0x80010000
    assert int(int_bound(start, 14)[0]) == 0xFFFFFFFF
    assert as_float_threshold(int_bound(start, 15))[0] < 0


@pytest.mark.parametrize("m,k", [(16, 9), (300, 12)])
def test_intpacked_infinite_distances_taken_below_the_start(rng, m, k):
    """Refs whose squared distances overflow to +inf: their keys
    (0x7F80 << idx_bits) | index lie below 2^30, so with fewer than k
    finite refs and no padding they are taken (idx_bits 4, and 9 where the
    start key's bound 0x800010000 saturates); a float threshold (NaN at the
    saturated bound, strict '<') refuses them and gives other keys."""
    q, r = tie_clouds(rng, 1, 40, m)
    r[0, 5:] = 3e19  # refs at an infinite distance
    want = check_intpacked(q, r, k, m)
    bits = packed_idx_bits(m)
    assert (want[0, :, 5:] < INT_START).all()
    assert ((want[0, :, 5:] & ((1 << bits) - 1)) >= 5).all()
    assert (want[0, :, 5:] >> bits == 0x7F80).all()
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    wrong = emulate_intpacked(qt, rt, k, m, 2, float_filter=True)
    assert not torch.equal(wrong, want)


def test_intpacked_nan_of_both_signs(rng):
    """NaN refs in rank 0's and the last rank's slices and a NaN query of
    each sign: never taken (a NaN with the sign bit clear has the bits
    0x7FC00000, below the start key's bound at idx_bits 15, and is refused
    by its own test); the NaN rows keep the start keys (their distances to
    the padding refs are NaN too)."""
    q, r = tie_clouds(rng, 1, 140, 400)
    r[0, 3, 1] = NEG_NAN
    r[0, 398, 0] = np.nan
    q[0, 7, 2] = NEG_NAN
    q[0, 139, 0] = np.nan
    for m_total in (512, 32768):
        want = check_intpacked(q, r, 4, m_total)
        idx = want & ((1 << packed_idx_bits(m_total)) - 1)
        assert not ((idx == 3) | (idx == 398)).any()
        assert (want[0, [7, 139]] == INT_START).all()


def test_intpacked_queries_past_the_block_and_plan(rng):
    """N not a multiple of 128 (padding queries scanned at the origin,
    never written); the plan's S at the int-packed kernel's two shapes."""
    q, r = tie_clouds(rng, 1, 257, 260)
    check_intpacked(q, r, 3, 2048)
    assert knn_topk_plan(1, 90_000, 30_000) == 2
    assert knn_topk_plan(1, 2_500, 30_000) == 8


# ---- pruned pass ----

def box_sq_dist(q, r):
    """``csrc/knn_pruned.cu::box_sq_dist`` from each query [R, 3] to the box
    of refs r [n, 3] (fminf / fmaxf drop a NaN), rounded op by op."""
    lo = torch.where(torch.isnan(r), np.inf, r).amin(0)
    hi = torch.where(torch.isnan(r), -np.inf, r).amax(0)
    g = torch.maximum(torch.maximum(lo - q, q - hi), torch.tensor(0.0))
    return (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]


def warps_scanning(lb, kth):
    """The rows whose warp of 32 scans the chunk: some query of the warp is
    nearer its box than its k-th distance (rows past the tile vote to
    skip)."""
    rows = kth.shape[0]
    near = torch.zeros(-(-rows // 32) * 32, dtype=torch.bool)
    near[:rows] = lb < kth
    return near.view(-1, 32).any(1).repeat_interleave(32)[:rows]


def emulate_pruned(qs, rs, skip, d_init, i_init, k, tq, tr, S, stats=None):
    """The kernel's split of each row's unskipped tiles over S ranks, their
    scans from (d_init, i_init) / the d_init[k-1] seed, chunk by chunk with
    each warp's box test, and rank 0's merge in rank order -> (d, i), like
    ``knn_pruned_pass_plain``; ``stats["skipped"]`` counts the (warp,
    chunk) pairs the box test lets go."""
    nq, nr = qs.shape[0] // tq, rs.shape[0] // tr
    d_out = torch.empty_like(d_init)
    i_out = torch.empty_like(i_init)
    for qi in range(nq):
        rows = slice(qi * tq, (qi + 1) * tq)
        q = qs[rows]
        tiles = [j for j in range(nr) if skip[qi, j] == 0]
        c = -(-len(tiles) // S)
        every = torch.ones(tq, dtype=torch.bool)
        lists = []
        for rank in range(S):
            if rank == 0:
                D, I = d_init[rows].clone(), i_init[rows].clone()
            else:
                D = d_init[rows, k - 1:k].repeat(1, k)
                I = torch.zeros((tq, k), dtype=torch.int32)
            for j in tiles[rank * c:(rank + 1) * c]:
                for off in range(0, tr, CHUNK):
                    base, n = j * tr + off, min(CHUNK, tr - off)
                    scans = warps_scanning(
                        box_sq_dist(q, rs[base:base + n]), D[:, -1])
                    if stats is not None:
                        stats["skipped"] += -(-int((~scans).sum()) // 32)
                    d = pairwise_sq_dist(q, rs[base:base + n])
                    for c0 in range(0, n - UNROLL + 1, UNROLL):
                        g = d[:, c0:c0 + UNROLL]
                        passed = scans & (fmin8(g) < D[:, -1])
                        for u in range(UNROLL):
                            D, I = sorted_insert(
                                D, I, g[:, u],
                                torch.full((tq,), base + c0 + u,
                                           dtype=torch.int32), passed)
                    for c1 in range(n - n % UNROLL, n):
                        D, I = sorted_insert(
                            D, I, d[:, c1], torch.full(
                                (tq,), base + c1, dtype=torch.int32), scans)
            lists.append((D, I))
        D, I = lists[0]
        for D_r, I_r in lists[1:]:
            for t in range(k):
                D, I = sorted_insert(D, I, D_r[:, t], I_r[:, t], every)
        d_out[rows], i_out[rows] = D, I
    return d_out, i_out


def pruned_inputs(rng, nq, nr, tq, tr):
    """Lattice queries and refs (equal distances) with duplicate refs across
    tiles; a first pass over a window of two tiles gives d_init, whose
    entries equal ref distances of the other tiles."""
    q, r = tie_clouds(rng, 1, nq * tq, nr * tr)
    qs, rs = torch.from_numpy(q[0]), torch.from_numpy(r[0])
    window = torch.zeros((nq, nr), dtype=torch.bool)
    for i in range(nq):
        lo = min(max(i * nr // nq - 1, 0), nr - 2)
        window[i, lo:lo + 2] = True
    return qs, rs, window


def check_pruned(qs, rs, skip, d0, i0, k, tq, tr, sizes=SIZES, stats=None):
    want = knn_pruned_pass_plain(qs, rs, skip, d0, i0, k, tq, tr)
    for S in sizes:
        got = emulate_pruned(qs, rs, skip, d0, i0, k, tq, tr, S, stats)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), S
        assert torch.equal(got[1], want[1]), S
    return want


@pytest.mark.parametrize("nq,nr,tq,tr,k", [
    (3, 6, 100, 64, 3),    # a block of 100 rows; whole groups of eight
    (2, 5, 130, 37, 9),    # two blocks a tile, ragged groups
    (2, 4, 64, 48, 16),    # k = 16
    (2, 9, 40, 24, 1),     # the nearest only; more tiles than 8 ranks
])
def test_pruned_split_equals_plain_on_both_passes(rng, nq, nr, tq, tr, k):
    """Pass 1 over the window, pass 2 from its state over a skip matrix with
    an empty row, a full row, a row of one tile (fewer than S) and random
    rows."""
    qs, rs, window = pruned_inputs(rng, nq, nr, tq, tr)
    d0 = torch.full((nq * tq, k), 1e30)
    i0 = torch.zeros((nq * tq, k), dtype=torch.int32)
    skip1 = (~window).int()
    d1, i1 = check_pruned(qs, rs, skip1, d0, i0, k, tq, tr)
    skip2 = torch.from_numpy(rng.random((nq, nr)) < 0.4) | window
    skip2[0] = True            # every tile skipped: the state as it came
    skip2[-1] = False          # none skipped
    if nq > 2:
        skip2[1] = True
        skip2[1, 2] = False    # one unskipped tile: ranks past 0 idle
    d2, i2 = check_pruned(qs, rs, skip2.int(), d1, i1, k, tq, tr)
    assert torch.equal(d2[:tq], d1[:tq]) and torch.equal(i2[:tq], i1[:tq])


def test_pruned_ties_with_the_initial_state_keep_it_first(rng):
    """d_init entries equal to distances of refs in the scanned tiles (all
    refs duplicated across tiles): the earlier pass's entry stays first,
    whichever rank finds the equal ref."""
    nq, nr, tq, tr, k = 2, 6, 64, 32, 4
    qs, rs, window = pruned_inputs(rng, nq, nr, tq, tr)
    rs = rs[:tr].repeat(nr, 1)  # every tile the same refs
    d0 = torch.full((nq * tq, k), 1e30)
    i0 = torch.zeros((nq * tq, k), dtype=torch.int32)
    first = torch.ones((nq, nr), dtype=torch.int32)
    first[:, 0] = 0
    d1, i1 = check_pruned(qs, rs, first, d0, i0, k, tq, tr)
    d2, i2 = check_pruned(qs, rs, 1 - first, d1, i1, k, tq, tr)
    # the nearest stays pass 1's; equal distances in ascending position
    assert torch.equal(d2[:, 0], d1[:, 0]) and torch.equal(i2[:, 0], i1[:, 0])
    tied = d2[:, 1:] == d2[:, :-1]
    assert (i2[:, 1:] > i2[:, :-1])[tied].all() and (i2 >= tr).any()


def test_pruned_warps_skip_far_chunks_exactly(rng):
    """Refs in slabs along x (each tile one slab), lattice values and
    duplicates, queries among them: from the first pass's state the second
    pass's warps let far chunks go, and the state is still the plain
    version's."""
    nq, nr, tq, tr, k = 3, 8, 64, 40, 3
    qs, rs, window = pruned_inputs(rng, nq, nr, tq, tr)
    rs = rs[torch.argsort(rs[:, 0], stable=True)].contiguous()
    qs = qs[torch.argsort(qs[:, 0], stable=True)].contiguous()
    d0 = torch.full((nq * tq, k), 1e30)
    i0 = torch.zeros((nq * tq, k), dtype=torch.int32)
    d1, i1 = check_pruned(qs, rs, (~window).int(), d0, i0, k, tq, tr)
    stats = {"skipped": 0}
    check_pruned(qs, rs, window.int(), d1, i1, k, tq, tr, stats=stats)
    visits = 4 * (nq * (nr - 2)) * -(-tq // 32)  # 4 sizes, warps x tiles
    assert visits // 8 < stats["skipped"] < visits


def test_pruned_box_test_at_its_edge():
    """A warp of 32 queries at the origin with k-th distance 1: a chunk whose
    nearest ref (0.8, 0, 0) lies on its box's face is scanned (box distance
    0.8 * 0.8 < 1) and the ref taken; a chunk whose nearest ref ties the k-th
    distance (box distance 1) is let go, as the strict '<' refuses it."""
    k, tq, tr = 3, 32, 8
    qs = torch.zeros((tq, 3))
    far = torch.full((tr, 3), 50.0)
    near = torch.tensor([[0.8, 0.0, 0.0], [0.9, 0.5, -0.5], [2.0, 1.0, 1.0]]
                        ).repeat(3, 1)[:tr]
    tie = near.clone()
    tie[0] = torch.tensor([1.0, 0.0, 0.0])
    tie[:, 0] += torch.tensor([0.0] + [0.5] * (tr - 1))
    rs = torch.cat([far, near, tie]).contiguous()
    d0 = torch.tensor([0.25, 0.5, 1.0]).repeat(tq, 1)
    i0 = torch.tensor([100, 101, 102], dtype=torch.int32).repeat(tq, 1)
    skip = torch.zeros((1, 3), dtype=torch.int32)
    d_near = pairwise_sq_dist(qs[:1], near[:1])[0, 0]  # 0.8 * 0.8
    assert box_sq_dist(qs[:1], near)[0] == d_near
    assert box_sq_dist(qs[:1], tie)[0] == 1.0
    stats = {"skipped": 0}
    d, i = check_pruned(qs, rs, skip, d0, i0, k, tq, tr, stats=stats)
    assert (i[:, 2] == tr).all() and (d[:, 2] == d_near).all()
    assert stats["skipped"] == 4 * 2  # the far and the tied chunk, each S


def test_pruned_nan_refs_of_both_signs_and_a_nan_query(rng):
    nq, nr, tq, tr, k = 2, 5, 48, 40, 3
    qs, rs, window = pruned_inputs(rng, nq, nr, tq, tr)
    rs[5, 0] = torch.from_numpy(np.array(NEG_NAN))
    rs[3 * tr + 17, 2] = float("nan")
    qs[11, 1] = torch.from_numpy(np.array(NEG_NAN))
    d0 = torch.full((nq * tq, k), 1e30)
    i0 = torch.zeros((nq * tq, k), dtype=torch.int32)
    skip = torch.zeros((nq, nr), dtype=torch.int32)
    d, i = check_pruned(qs, rs, skip, d0, i0, k, tq, tr)
    assert not ((i == 5) | (i == 3 * tr + 17)).any()
    assert (d[11] == np.float32(1e30)).all()


def tile_of_slot(skip, slot):
    """``csrc/knn_pruned.cu::tile_of_slot``: the rows' counts of unskipped
    tiles, their histogram, the count that holds the slot (from the largest
    down), then the slot's ordinal among the tiles of that count, found 32
    tiles at a time as warp 0's ballots do."""
    counts = (skip == 0).sum(1).tolist()
    nq, nr = skip.shape
    hist = [counts.count(c) for c in range(nr + 1)]
    before, c = 0, nr
    while before + hist[c] <= slot:
        before += hist[c]
        c -= 1
    left = slot - before
    for base in range(0, nq, 32):
        hits = [i for i in range(base, min(base + 32, nq)) if counts[i] == c]
        if left < len(hits):
            return hits[left]
        left -= len(hits)
    raise AssertionError("the slot is past the tiles")


@pytest.mark.parametrize("nq,nr", [(176, 15), (7, 3), (300, 40), (1, 2)])
def test_pruned_clusters_take_the_longest_rows_first(rng, nq, nr):
    """The clusters' slots map to the query tiles in descending order of
    unskipped ref tiles, ties by index: a permutation, so every tile is
    served once and the results do not depend on it."""
    skip = torch.from_numpy(rng.random((nq, nr)) < rng.random((nq, 1)))
    skip[: nq // 3] = skip[0]  # many ties
    order = [tile_of_slot(skip, g) for g in range(nq)]
    want = torch.argsort((skip == 0).sum(1), descending=True, stable=True)
    assert order == want.tolist()


def test_box_distance_never_exceeds_a_refs(rng):
    """The chunk test's bound, rounded op by op: at most the distance to
    every ref of the box (zero inside it), on lattice points, exact
    duplicates, queries on refs and far queries; so a skipped chunk holds
    no ref the strict '<' would take."""
    q, r = tie_clouds(rng, 1, 2000, 300)
    q, r = torch.from_numpy(q[0]), torch.from_numpy(r[0])
    q[:50] *= 1e5
    q[50:60] = r[:10] + torch.tensor([1e-7, -3e-8, 0.0])
    for lo, hi in ((0, 300), (0, 1), (17, 40), (299, 300)):
        lb = box_sq_dist(q, r[lo:hi])
        d = pairwise_sq_dist(q, r[lo:hi])
        assert (lb[:, None] <= d).all()
    assert (box_sq_dist(r[:5], r) == 0).all()


def test_pruned_source_cluster_size_at_the_sampler_shape():
    """The source's S at 90,000 x 30,000 (176 query tiles of 512, 15 ref
    tiles of 2,048): clusters of S blocks of 128 queries fill the card."""
    blocks = 176 * (512 // THREADS) * SOURCE_S
    assert SOURCE_S in SIZES and blocks >= 132
