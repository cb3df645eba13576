"""The kd-grid's slot-run kernels skip the layout's padding rows, held on the
CPU with the plain versions and an emulation of ``csrc/grid_fused.cu``'s
scan.

* ``_layout_slots`` returns ``n_real`` [T] int32 = ``real.sum(1)``, and the
  real rows of every tile are its first ``n_real`` rows.
* On the grid's own layouts (all three slot shapes) the plain versions with
  ``n_real`` give exactly what they give without it, on every row: a padding
  query lies at 1e15 and never beats the start list (1e30, 0).
* A row at or past ``n_real`` gets the start list even when its query lies
  among the refs.
* The kernel's scan, emulated step by step (the runs staged chunk by
  chunk in its order, the middle third of the middle slot first; eight refs
  a step tried only when their ``fminf`` is <= the k-th distance, inserts
  on (distance, position); warps without a real row skipped, padding rows
  reset), equals ``grid_topk_plain`` bit for bit for any chunk and any slot
  order, with exact ties and NaN refs of both signs.
"""

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_torch.ops.kernels import (grid_interp_plain,
                                                         grid_topk_plain)
from pointcloud_style_transfer_torch.ops.kernels._common import \
    pairwise_sq_dist

# (grid_shape, slot_cap, xy_halo, M, Nq): y-run slots, whole-column pairs,
# windowed z-runs
LAYOUTS = [((4, 4, 5), 384, 1, 2000, 3000), ((1, 2, 5), 512, 1, 700, 1500),
           ((4, 4, 5), 128, 1, 2000, 3000)]


def layout(rng, grid_shape, slot_cap, xy_halo, M, Nq, tq=64):
    """The grid's structure and layout over a cloud with exact duplicate
    refs and queries on refs: (slots, refs_pad, sorted values)."""
    r = (rng.standard_normal((M, 3)) * 2).astype(np.float32)
    q = (rng.standard_normal((Nq, 3)) * 2).astype(np.float32)
    r[rng.choice(M, M // 10, replace=False)] = r[rng.choice(M, M // 10)]
    q[: Nq // 10] = r[rng.choice(M, Nq // 10)]
    v = torch.from_numpy(rng.standard_normal((M, 3)).astype(np.float32))
    struct = P._build_struct(torch.from_numpy(r), grid_shape,
                             skip_z_sort=P._full_z_ok(M, grid_shape, slot_cap))
    sl = P._layout_slots(struct, torch.from_numpy(q), grid_shape, tq,
                         slot_cap, 2, xy_halo)
    return sl, struct.refs_pad, P._sorted_values(struct, v)


@pytest.mark.parametrize("grid_shape,slot_cap,xy_halo,M,Nq", LAYOUTS)
def test_layout_counts_real_rows(rng, grid_shape, slot_cap, xy_halo, M, Nq):
    sl, _, _ = layout(rng, grid_shape, slot_cap, xy_halo, M, Nq)
    T, tq = sl.real.shape
    assert sl.n_real.dtype == torch.int32 and sl.n_real.shape == (T,)
    assert torch.equal(sl.n_real, sl.real.sum(1).int())
    prefix = torch.arange(tq)[None, :] < sl.n_real[:, None]
    assert torch.equal(sl.real, prefix)
    assert int(sl.n_real.sum()) == Nq
    assert (sl.n_real == 0).any() and ((sl.n_real > 0) & (sl.n_real < tq)).any()


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("grid_shape,slot_cap,xy_halo,M,Nq", LAYOUTS)
def test_plain_with_real_rows_equals_without(rng, grid_shape, slot_cap,
                                             xy_halo, M, Nq, k):
    sl, refs, vals = layout(rng, grid_shape, slot_cap, xy_halo, M, Nq)
    args = (sl.q_pad, refs, sl.st, sl.en, k)
    d, i = grid_topk_plain(*args)
    d_r, i_r = grid_topk_plain(*args, n_real=sl.n_real)
    assert torch.equal(d_r.view(torch.int32), d.view(torch.int32))
    assert torch.equal(i_r, i)
    v, d2 = grid_interp_plain(sl.q_pad, refs, vals, sl.st, sl.en, k)
    v_r, d2_r = grid_interp_plain(sl.q_pad, refs, vals, sl.st, sl.en, k,
                                  n_real=sl.n_real)
    assert torch.equal(v_r.view(torch.int32), v.view(torch.int32))
    assert torch.equal(d2_r, d2)
    pad = ~sl.real.reshape(-1)
    assert (d[pad] == 1e30).all() and (i[pad] == 0).all()
    assert (d[~pad, 0] < 1e29).all()


def test_padding_rows_get_the_start_list(rng):
    """n_real cuts real queries too: rows at or past it, and every row of a
    tile with n_real = 0, hold (1e30, 0); the rows before it keep theirs."""
    sl, refs, _ = layout(rng, (4, 4, 5), 384, 1, 2000, 3000)
    tq = sl.real.shape[1]
    full = int(torch.nonzero(sl.n_real == tq)[0, 0])
    cut = sl.n_real.clone()
    cut[full] = 0
    some = int(torch.nonzero((sl.n_real > 40) & (cut > 0))[0, 0])
    cut[some] = 40
    d, i = grid_topk_plain(sl.q_pad, refs, sl.st, sl.en, 3)
    d_c, i_c = grid_topk_plain(sl.q_pad, refs, sl.st, sl.en, 3, n_real=cut)
    rows = torch.arange(sl.q_pad.shape[0]).reshape(-1, tq)
    gone = torch.cat([rows[full], rows[some, 40:]])
    assert (d[gone, 0] < 1e29).all()
    assert (d_c[gone] == 1e30).all() and (i_c[gone] == 0).all()
    kept = torch.ones(len(d), dtype=torch.bool)
    kept[gone] = False
    assert torch.equal(d_c[kept], d[kept]) and torch.equal(i_c[kept], i[kept])
    # n_real is clipped to [0, tq], as the kernels clip it
    wide = sl.n_real.clone()
    wide[full] = tq + 5
    wide[some] = -3
    d_w, _ = grid_topk_plain(sl.q_pad, refs, sl.st, sl.en, 3, n_real=wide)
    assert torch.equal(d_w[rows[full]], d[rows[full]])
    assert (d_w[rows[some]] == 1e30).all()


def before(d, p, e, q):
    """(d, p) lexicographically before (e, q); False for a NaN d."""
    return (d < e) | ((d == e) & (p < q))


def insert(D, I, d, p, mask):
    """The kernel's insert, on the rows of ``mask`` at once."""
    take = mask & before(d, p, D[:, -1], I[:, -1])
    if not take.any():
        return
    D[take, -1], I[take, -1] = d[take], p[take]
    for t in range(D.shape[1] - 1, 0, -1):
        sw = take & before(D[:, t], I[:, t], D[:, t - 1], I[:, t - 1])
        D[sw, t], D[sw, t - 1] = D[sw, t - 1], D[sw, t]
        I[sw, t], I[sw, t - 1] = I[sw, t - 1], I[sw, t]


def staging_order(st, en, M_pad):
    """A tile's candidates in the kernel's staging order: the middle third
    of the middle slot's run, its first and last thirds, the other slots'
    runs in slot order."""
    lo = st.long().clamp(min=0)
    ln = (en.long().clamp(max=M_pad) - lo).clamp(min=0)
    S = len(lo)
    if S == 0:
        return torch.zeros(0, dtype=torch.int64)
    m = S // 2
    a, b = int(ln[m]) // 3, 2 * int(ln[m]) // 3
    mlo, mlen = int(lo[m]), int(ln[m])
    pieces = [(mlo + a, b - a), (mlo, a), (mlo + b, mlen - b)]
    pieces += [(int(lo[s]), int(ln[s])) for s in range(S) if s != m]
    return torch.cat([torch.arange(x, x + n) for x, n in pieces])


def kernel_scan(q_pad, refs, st, en, k, n_real=None, chunk=1536):
    """``grid_topk_kernel`` step by step: one tile at a time, its rows at
    once."""
    T, S = st.shape
    tq = q_pad.shape[0] // T
    M_pad = refs.shape[0]
    D = torch.full((T * tq, k), 1e30)
    I = torch.zeros((T * tq, k), dtype=torch.int64)
    for t in range(T):
        nr = tq if n_real is None else min(max(int(n_real[t]), 0), tq)
        if nr == 0:
            continue
        scan = min(tq, -(-nr // 32) * 32)  # warps holding a real row
        rows = torch.arange(t * tq, t * tq + scan)
        pos = staging_order(st[t], en[t], M_pad)
        Dt, It = D[rows], I[rows]
        every = torch.ones(len(rows), dtype=torch.bool)
        for c0 in range(0, len(pos), chunk):
            p = pos[c0:c0 + chunk]
            d = pairwise_sq_dist(q_pad[rows], refs[p])  # [scan, n]
            j = 0
            while j + 8 <= len(p):
                lowest = d[:, j]
                for u in range(1, 8):
                    lowest = torch.fmin(lowest, d[:, j + u])  # drops a NaN
                go = lowest <= Dt[:, -1]
                for u in range(8):
                    insert(Dt, It, d[:, j + u], p[j + u].expand(len(rows)),
                           go)
                j += 8
            for jj in range(j, len(p)):
                insert(Dt, It, d[:, jj], p[jj].expand(len(rows)), every)
        keep = rows < t * tq + nr
        D[rows[keep]], I[rows[keep]] = Dt[keep], It[keep]
    return D, I.clamp(0, M_pad - 1).int()


@pytest.mark.parametrize("chunk", [5, 64, 1536])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_kernel_scan_equals_plain(rng, k, chunk):
    """Lattice refs (exact ties at equal distances), NaN refs of both signs
    in the runs, the slot columns shuffled (the tie rule holds for any slot
    order), with and without n_real."""
    sl, refs, _ = layout(rng, (1, 2, 5), 512, 1, 700, 600)
    refs = torch.round(refs * 2) / 2
    q_pad = torch.where(sl.real.reshape(-1, 1), torch.round(sl.q_pad * 2) / 2
                        + 0.25, sl.q_pad)
    nan_pos = [int(sl.st[t, s]) + 2 for t in range(sl.st.shape[0])
               for s in range(sl.st.shape[1]) if sl.en[t, s] > sl.st[t, s] + 2]
    for j, p in enumerate(nan_pos[:6]):
        refs[p, j % 3] = float("nan") if j % 2 else -float("nan")
    perm = torch.from_numpy(rng.permutation(sl.st.shape[1]))
    st, en = sl.st[:, perm].contiguous(), sl.en[:, perm].contiguous()
    for n_real in (None, sl.n_real):
        d, i = grid_topk_plain(q_pad, refs, st, en, k, n_real=n_real)
        d_e, i_e = kernel_scan(q_pad, refs, st, en, k, n_real, chunk)
        assert torch.equal(d_e.view(torch.int32), d.view(torch.int32))
        assert torch.equal(i_e, i)
        assert not torch.isin(i[d < 1e29], torch.tensor(nan_pos[:6])).any()
    assert (d[:, 0] < 1e29).sum() > 100
