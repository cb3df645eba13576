"""The kNN family never takes a NaN distance, whatever its sign bit, and the
kNN and FPS wrappers take any k and any cloud size; held on the CPU with the
plain versions.

* NaN refs of either sign (x86 arithmetic makes NaNs with the sign bit set,
  whose raw bits sort below every distance): the plain exact kNN, the grid's
  slot-run twins, both packed-key twins and the pruned pass never select
  them, their lists stay ascending, and the answer is the one a far ref
  (never within 1e30) or the other sign gives.
* ``knn_topk`` past the register lists' 16 (the CUDA global-list kernel's
  range) on CPU tensors: identical to a numpy scan and to an emulation of
  that kernel's shift insert behind its eight-ref filter.
* FPS past the registers' 65,536 points: ``fps_plan`` takes the streaming
  kernel, and the CPU path equals a numpy FPS at 70,000 points.
"""

import math

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels import (
    farthest_point_sample_kernel, grid_interp_plain, grid_topk_plain, knn_topk,
    knn_topk_plain, knn_pruned_pass_plain)
from pointcloud_style_transfer_torch.ops.kernels import fps as fps_mod
from pointcloud_style_transfer_torch.ops.kernels import knn_packed
from pointcloud_style_transfer_torch.ops.kernels._common import \
    pairwise_sq_dist
from pointcloud_style_transfer_torch.ops.kernels.fps import (MAX_POINTS,
                                                             STREAM, fps_plan)

SIGNS = [1.0, -1.0]
FAR = 1e15  # a ref this far is never within the start list's 1e30


def nan(sign):
    return math.copysign(float("nan"), sign)


def clouds(rng, n, m, b=1):
    """Lattice refs and queries (exact ties) with queries on refs."""
    r = np.round(rng.standard_normal((b, m, 3)) * 2) / 2
    q = np.round(rng.standard_normal((b, n, 3)) * 2) / 2 + 0.25
    q[:, : n // 4] = r[:, rng.choice(m, n // 4)]
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(r.astype(np.float32)))


def with_bad_refs(r, idx, sign):
    """Copies of r with refs ``idx`` NaN (of ``sign``) and far away."""
    r_nan, r_far = r.clone(), r.clone()
    for j, i in enumerate(idx):
        r_nan[..., i, j % 3] = nan(sign)
        r_far[..., i, :] = FAR
    assert bool(torch.signbit(r_nan[..., idx[0], 0]).all()) == (sign < 0)
    return r_nan, r_far


@pytest.mark.parametrize("sign", SIGNS)
def test_knn_plain_reproducer(sign):
    """Query (0,0,0), refs x = NaN, 2, 3, 4, k = 2: the two real nearest."""
    q = torch.zeros(1, 1, 3)
    r = torch.zeros(1, 4, 3)
    r[0, :, 0] = torch.tensor([nan(sign), 2.0, 3.0, 4.0])
    d, i = knn_topk_plain(q, r, 2)
    assert d.tolist() == [[[4.0, 9.0]]] and i.tolist() == [[[1, 2]]]
    st = torch.tensor([[0]], dtype=torch.int32)
    en = torch.tensor([[4]], dtype=torch.int32)
    d, i = grid_topk_plain(q[0], r[0], st, en, 2)
    assert d.tolist() == [[4.0, 9.0]] and i.tolist() == [[1, 2]]


@pytest.mark.parametrize("k", [1, 4, 20])
@pytest.mark.parametrize("sign", SIGNS)
def test_knn_plain_never_takes_nan(rng, sign, k):
    q, r = clouds(rng, 200, 300)
    bad = [0, 7, 150, 299]
    r_nan, r_far = with_bad_refs(r, bad, sign)
    d, i = knn_topk_plain(q, r_nan, k)
    d_f, i_f = knn_topk_plain(q, r_far, k)
    assert torch.equal(d.view(torch.int32), d_f.view(torch.int32))
    assert torch.equal(i, i_f)
    assert not torch.isin(i[d < 1e29], torch.tensor(bad)).any()
    assert (d[..., 1:] >= d[..., :-1]).all()
    d_cpu, _ = knn_topk(q, r_nan, k)  # the CPU dispatch: the plain version
    assert torch.equal(d_cpu, d)


def grid_tables(T, tq, m, rng):
    """Slot tables of three disjoint runs a tile, one run per third of the
    refs."""
    st = np.zeros((T, 3), np.int32)
    en = np.zeros((T, 3), np.int32)
    third = m // 3
    for t in range(T):
        for s in range(3):
            a = s * third + int(rng.integers(0, third // 2))
            st[t, s], en[t, s] = a, a + int(rng.integers(1, third // 2))
    return torch.from_numpy(st), torch.from_numpy(en)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("sign", SIGNS)
def test_grid_plain_never_takes_nan(rng, sign, k):
    T, tq, m = 6, 32, 384
    q, r = clouds(rng, T * tq, m)
    q, r = q[0], r[0]
    st, en = grid_tables(T, tq, m, rng)
    bad = [int(st[t, s]) for t in range(T) for s in range(3)]
    r_nan, r_far = with_bad_refs(r, bad, sign)
    vals = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32))
    d, i = grid_topk_plain(q, r_nan, st, en, k)
    d_f, i_f = grid_topk_plain(q, r_far, st, en, k)
    assert torch.equal(d.view(torch.int32), d_f.view(torch.int32))
    assert torch.equal(i, i_f)
    assert not torch.isin(i[d < 1e29], torch.tensor(bad)).any()
    assert (d[:, 1:] >= d[:, :-1]).all() and (d[:, -1] < 1e29).all()
    v, d2 = grid_interp_plain(q, r_nan, vals, st, en, k)
    v_f, _ = grid_interp_plain(q, r_far, vals, st, en, k)
    assert torch.equal(d2, d) and torch.equal(v, v_f)
    assert torch.isfinite(v).all()


@pytest.mark.parametrize("packing", ["f32", "int"])
def test_packed_keys_never_take_nan(rng, packing):
    """Either packing: NaN refs of both signs give the same keys, none of
    them decodes to a NaN ref, the keys ascend; with the f32 key, a far ref
    gives the same keys as a NaN one."""
    k, m_total = 6, 512
    q, r = clouds(rng, 150, 400)
    bad = [0, 5, 200, 399]
    keys_of = (knn_packed.knn_f32packed_keys_plain if packing == "f32"
               else knn_packed.knn_intpacked_keys_plain)
    idx_bits = 15 if packing == "f32" else knn_packed.packed_idx_bits(m_total)
    got = {}
    for sign in SIGNS:
        r_nan, r_far = with_bad_refs(r, bad, sign)
        got[sign] = keys_of(q, r_nan, k, m_total).view(torch.int32)
        if packing == "f32":
            far = keys_of(q, r_far, k, m_total).view(torch.int32)
            assert torch.equal(got[sign], far)
    keys = got[1.0]
    assert torch.equal(got[-1.0], keys)
    assert (keys[..., 1:] >= keys[..., :-1]).all()
    idx = keys & ((1 << idx_bits) - 1)
    assert not torch.isin(idx, torch.tensor(bad)).any()


@pytest.mark.parametrize("sign", SIGNS)
def test_pruned_pass_never_takes_nan(rng, sign):
    k, tq, tr = 3, 64, 128
    q, r = clouds(rng, 2 * tq, 3 * tr)
    q, r = q[0], r[0]
    bad = [1, 130, 300]
    r_nan, r_far = with_bad_refs(r, bad, sign)
    skip = torch.zeros((2, 3), dtype=torch.int32)
    d0 = torch.full((2 * tq, k), 1e30)
    i0 = torch.zeros((2 * tq, k), dtype=torch.int32)
    d, i = knn_pruned_pass_plain(q, r_nan, skip, d0, i0, k, tq, tr)
    d_f, i_f = knn_pruned_pass_plain(q, r_far, skip, d0, i0, k, tq, tr)
    assert torch.equal(d, d_f) and torch.equal(i, i_f)
    assert not torch.isin(i, torch.tensor(bad)).any()
    assert (d[:, 1:] >= d[:, :-1]).all()


def numpy_knn(q, r, k):
    """The k nearest by (distance, index), float32 distances in the kernels'
    form; (1e30, 0) where fewer than k refs lie below 1e30; indices
    clipped."""
    d = pairwise_sq_dist(q, r).numpy()  # [n, m]
    n, m = d.shape
    order = np.lexsort((np.broadcast_to(np.arange(m), d.shape), d), axis=1)
    kk = min(k, m)
    d_out = np.full((n, k), 1e30, np.float32)
    i_out = np.zeros((n, k), np.int32)
    d_out[:, :kk] = np.take_along_axis(d, order[:, :kk], 1)
    i_out[:, :kk] = order[:, :kk]
    i_out[d_out >= 1e30] = 0
    d_out[d_out >= 1e30] = 1e30
    return d_out, np.clip(i_out, 0, m - 1)


def global_list_scan(q, r, k):
    """``knn_topk_global_kernel``: refs in ascending index, eight at a time
    tried only when their minimum beats the k-th distance, each taken on
    strict '<' by shifting the larger entries up one."""
    d = pairwise_sq_dist(q, r)
    n, m = d.shape
    D = torch.full((n, k), 1e30)
    I = torch.zeros((n, k), dtype=torch.int64)
    rows = torch.arange(n)
    for j0 in range(0, m, 8):
        block = range(j0, min(j0 + 8, m))
        go = torch.ones(n, dtype=torch.bool)
        if len(block) == 8:  # fminf: a NaN drops out of the minimum
            eight = d[:, j0:j0 + 8]
            lowest = torch.where(torch.isnan(eight), float("inf"), eight)
            go = lowest.min(dim=1).values < D[:, -1]
        for j in block:
            take = go & (d[:, j] < D[:, -1])
            if not take.any():
                continue
            t = take.nonzero()[:, 0]
            pos = (D[t] <= d[t, j, None]).sum(1)  # after every entry <= d
            keep = torch.arange(k)[None, :] < pos[:, None]
            shifted_d = torch.cat([D[t, :1], D[t, :-1]], 1)
            shifted_i = torch.cat([I[t, :1], I[t, :-1]], 1)
            new_d = torch.where(keep, D[t], shifted_d)
            new_i = torch.where(keep, I[t], shifted_i)
            new_d[rows[:len(t)], pos] = d[t, j]
            new_i[rows[:len(t)], pos] = j
            D[t], I[t] = new_d, new_i
    return D, I.clamp(0, m - 1).int()


@pytest.mark.parametrize("k,m", [(17, 10), (17, 300), (33, 40), (33, 300)])
def test_knn_past_16_on_cpu(rng, k, m):
    q, r = clouds(rng, 64, m)
    r[0, 9, 2] = -float("nan")
    d, i = knn_topk(q, r, k)
    assert d.shape == (1, 64, k) and i.dtype == torch.int32
    r_far = r.clone()
    r_far[0, 9] = FAR
    d_n, i_n = numpy_knn(q[0], r_far[0], k)
    np.testing.assert_array_equal(d[0].numpy().view(np.int32),
                                  d_n.view(np.int32))
    np.testing.assert_array_equal(i[0].numpy(), i_n)
    d_e, i_e = global_list_scan(q[0], r[0], k)
    assert torch.equal(d_e.view(torch.int32), d[0].view(torch.int32))
    assert torch.equal(i_e, i[0])


def numpy_fps(xyz, npoint, start):
    """FPS in numpy float32: distances (dx*dx + dy*dy) + dz*dz, the first
    index of the maximum."""
    dist = np.full(len(xyz), 1e10, np.float32)
    out, far = [], start
    for _ in range(npoint):
        out.append(far)
        dx, dy, dz = (xyz - xyz[far]).T
        dist = np.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        far = int(np.argmax(dist))
    return np.array(out, np.int32)


def test_fps_past_the_register_cap_on_cpu(rng):
    n = 70000
    assert n > MAX_POINTS and fps_plan(n) == (8, 1024, STREAM)
    xyz = np.round(rng.standard_normal((2, n, 3)) * 8).astype(np.float32) / 8
    start = rng.integers(0, n, 2).astype(np.int32)
    got = farthest_point_sample_kernel(torch.from_numpy(xyz), 8,
                                       torch.from_numpy(start))
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      numpy_fps(xyz[b], 8, int(start[b])))


@pytest.mark.parametrize("n", [MAX_POINTS + 1, 70000, 120000, 10 ** 6])
def test_fps_plan_streams_above_the_cap(n):
    plan = fps_plan(n)
    assert plan[2] == STREAM
    fps_mod._check_plan(plan, n)
    fps_mod._check_plan((2, 64, STREAM), 7)  # forced on a small cloud
    with pytest.raises(ValueError):
        fps_mod._check_plan((8, 1024, 8), n)  # registers cannot hold it
