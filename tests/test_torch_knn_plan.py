"""The launch plans of the kNN and FPS kernels, and the two merge rules their
thread-block clusters rest on, held on the CPU with the plain versions.

``knn_topk`` splits the ref axis across the S ranks of a cluster and merges
the ranks' lists in rank order with the scan's own strict-'<' insert; ``fps``
splits the cloud across ranks and reduces the ranks' winners by (larger
value, then lower index). Each emulation here must give exactly what the
plain version gives on the whole: indices and distance bits identical.
"""

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels.fps import (
    CLUSTER_SIZES as FPS_CLUSTER_SIZES, MAX_POINTS, MAX_THREADS, PERS,
    fps_plain, fps_plan)
from pointcloud_style_transfer_torch.ops.kernels.knn import (
    CLUSTER_SIZES, knn_topk_plain, knn_topk_plan)


def rank_slices(n, S):
    """The slice [lo, hi) of an axis of n that each rank of an S-block
    cluster owns, as csrc/knn_topk.cu and csrc/fps.cu compute it: chunks of
    ceil(n / S), contiguous and ascending with the rank, empty past n."""
    chunk = -(-n // S)
    return [(min(n, r * chunk), min(n, r * chunk + chunk)) for r in range(S)]


def assert_slices(slices, n, S):
    """S contiguous, ascending, non-empty slices covering [0, n)."""
    assert len(slices) == S and slices[0][0] == 0 and slices[-1][1] == n
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


@pytest.mark.parametrize("B,nq,m,k", [
    (1, 1, 1, 1), (1, 1, 30000, 3), (1, 100, 30000, 3), (1, 500, 30000, 3),
    (1, 1825, 30000, 3), (1, 2500, 30000, 3), (1, 4096, 30000, 3),
    (1, 16384, 30000, 3), (1, 32768, 30000, 3), (1, 90000, 30000, 3),
    (1, 30000, 30000, 1), (1, 30000, 30000, 9), (1, 30000, 30000, 16),
    (2, 1000, 2500, 16), (1, 700, 5, 8), (3, 64, 1023, 4), (1, 10, 9000, 3),
    (1, 2500, 30000, 1), (1, 90000, 30000, 16), (2, 120000, 120000, 9),
])
def test_knn_plan_is_valid_and_covers_refs(B, nq, m, k):
    S = knn_topk_plan(B, nq, m)
    assert S in CLUSTER_SIZES
    slices = rank_slices(m, S)
    assert_slices(slices, m, S)
    if S > 1:  # every rank scans at least 1,024 refs
        assert min(hi - lo for lo, hi in slices) >= 1024


def test_knn_plan_splits_the_refs_only_for_few_queries():
    for rows in (500, 1825, 2500, 4096):  # the kd-grid's patches
        assert knn_topk_plan(1, rows, 30000) > 1
    # two 90,000-query clouds: 1,408 blocks, 10.67 per SM, already even
    assert knn_topk_plan(2, 90000, 30000) == 1
    assert knn_topk_plan(1, 2500, 1500) == 1  # too few refs to split


@pytest.mark.parametrize("nq,S", [(500, 8), (1825, 8), (2500, 8), (4096, 8),
                                  (16384, 4), (32768, 2), (90000, 2)])
def test_knn_plan_takes_the_fastest_measured_cluster(nq, S):
    """The cluster size that measured fastest, or within 2% of the fastest,
    at nq x 30,000, k = 3 on an H100 (``tools/sweep_kernel_plans.py``,
    PERF.md PR 5): the kd-grid's patches and the brute path."""
    assert knn_topk_plan(1, nq, 30000) == S


@pytest.mark.parametrize("n", [1, 7, 512, 4096, 8192, 30000, 40000, 65536])
def test_fps_plan_holds_the_cloud(n):
    S, threads, per = fps_plan(n)
    assert S in FPS_CLUSTER_SIZES and per in PERS
    assert 32 <= threads <= MAX_THREADS and threads & (threads - 1) == 0
    slices = rank_slices(n, S)
    assert_slices(slices, n, S)
    assert max(hi - lo for lo, hi in slices) <= threads * per


def test_fps_plan_clusters_large_clouds_only():
    assert fps_plan(512)[0] == 1 and fps_plan(30000)[0] > 1
    assert fps_plan(MAX_POINTS) == (8, 1024, 8)


def insert(D, I, d, i):
    """The kernel's sorted insert on strict '<', on every row at once."""
    D, I = D.clone(), I.clone()
    take = d < D[:, -1]  # a NaN never passes
    D[take, -1], I[take, -1] = d[take], i[take]
    for t in range(D.shape[1] - 1, 0, -1):
        swap = D[:, t] < D[:, t - 1]
        D[swap, t], D[swap, t - 1] = D[swap, t - 1], D[swap, t]
        I[swap, t], I[swap, t - 1] = I[swap, t - 1], I[swap, t]
    return D, I


def knn_by_ranks(q, r, k, S):
    """The cluster's kNN: each rank's top-k over its ref slice (indices
    offset by the slice's start), merged into rank 0's lists in rank order
    and list order, then clipped to [0, M-1]."""
    B, N, _ = q.shape
    M = r.shape[1]
    d_out, i_out = [], []
    for b in range(B):
        lists = []
        for lo, hi in rank_slices(M, S):
            if lo < hi:
                d, i = knn_topk_plain(q[b:b + 1], r[b:b + 1, lo:hi], k)
                lists.append((d[0], i[0] + lo))
            else:  # an empty slice leaves its start lists
                lists.append((torch.full((N, k), 1e30),
                              torch.zeros((N, k), dtype=torch.int32)))
        D, I = lists[0]
        for d, i in lists[1:]:
            for t in range(k):
                D, I = insert(D, I, d[:, t], i[:, t])
        d_out.append(D)
        i_out.append(I.clamp(0, M - 1))
    return torch.stack(d_out), torch.stack(i_out)


def tie_clouds(rng, b, n, m):
    """Lattice refs with exact duplicates spread over the whole ref axis (so
    equal distances straddle the rank boundaries) and queries on refs."""
    r = np.round(rng.standard_normal((b, m, 3)) * 2) / 2
    r[:, rng.choice(m, m // 3, replace=False)] = r[:, rng.choice(m, m // 3)]
    q = np.round(rng.standard_normal((b, n, 3)) * 2) / 2 + 0.25
    q[:, : n // 3] = r[:, rng.choice(m, n // 3)]
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(r.astype(np.float32)))


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("b,n,m,k", [
    (1, 200, 1000, 3),  # ties within and across slices
    (2, 150, 777, 16),  # m not a multiple of S
    (1, 100, 37, 9),    # slices shorter than k
    (1, 50, 5, 8),      # k > M: fill entries, and empty slices at S = 8
    (1, 120, 300, 1),   # the Chamfer gradient's k
])
def test_rank_merge_equals_one_scan(rng, S, b, n, m, k):
    q, r = tie_clouds(rng, b, n, m)
    d, i = knn_by_ranks(q, r, k, S)
    d_p, i_p = knn_topk_plain(q, r, k)
    assert torch.equal(i, i_p)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_rank_merge_never_takes_a_nan(rng, S):
    q, r = tie_clouds(rng, 1, 100, 400)
    r[0, 7, 1] = float("nan")  # in rank 0's slice
    r[0, 390, 0] = float("nan")  # in the last rank's slice
    d, i = knn_by_ranks(q, r, 4, S)
    d_p, i_p = knn_topk_plain(q, r, 4)
    assert torch.equal(i, i_p)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
    assert not ((i == 7) | (i == 390)).any() and torch.isfinite(d).all()


def fps_by_ranks(xyz, npoint, start, S):
    """The cluster's FPS: every rank's argmax over its slice (lowest index
    on equal values), then the ranks' winners reduced by (larger value, then
    lower index)."""
    B, N, _ = xyz.shape
    dist = torch.full((B, N), 1e10)
    out = torch.empty((B, npoint), dtype=torch.int32)
    bidx = torch.arange(B)
    far = start.long()
    slices = [s for s in rank_slices(N, S) if s[0] < s[1]]
    for it in range(npoint):
        out[:, it] = far
        c = xyz[bidx, far]
        dx = xyz[..., 0] - c[:, 0:1]
        dy = xyz[..., 1] - c[:, 1:2]
        dz = xyz[..., 2] - c[:, 2:3]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        best_v = torch.full((B,), -float("inf"))
        best_i = torch.full((B,), N, dtype=torch.int64)
        for lo, hi in reversed(slices):  # the rule, not the order, decides
            j = torch.argmax(dist[:, lo:hi], dim=1) + lo
            v = dist[bidx, j]
            take = (v > best_v) | ((v == best_v) & (j < best_i))
            best_v = torch.where(take, v, best_v)
            best_i = torch.where(take, j, best_i)
        far = best_i
    return out


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("b,n,npoint", [(3, 1000, 64), (1, 513, 40),
                                        (2, 9, 12)])
def test_rank_argmax_equals_fps_plain(rng, S, b, n, npoint):
    x = np.round(rng.standard_normal((b, n, 3)) * 2) / 2  # lattice: ties
    half = n // 2  # the first half repeated in the second: every maximum
    x[:, half: 2 * half] = x[:, :half]  # ties with a point of another rank
    xyz = torch.from_numpy(x.astype(np.float32))
    start = torch.from_numpy(rng.integers(0, n, b).astype(np.int32))
    assert torch.equal(fps_by_ranks(xyz, npoint, start, S),
                       fps_plain(xyz, npoint, start))
