"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a GPU with the CUDA toolkit (the kernels are built from ``csrc/`` on
first use); skipped without one. The file needs no JAX, so on a GPU machine
without it run ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda
--noconftest -q``. Indices must be identical, kNN distances within 1e-6
relative (same float32 arithmetic, no FMA); under every cluster size the kNN
kernel's indices and distance bits, and under every launch plan FPS's
indices, are identical to the plain versions'. The row minimum is identical
to its plain version, NaN rows included, built with every cluster size S
and queries a thread Q; the ball query kernel's indices are identical to
its plain version's on rows with no hit, hits in the last partial round or
ending on a round or warp boundary, fewer points than nsample, NaN points
and centers of both signs, built with the source's and four other (warps,
steps a round); ``MinSqDist``'s gradients on the
card are within 1e-6 relative of the CPU's (the card's scatter-add into the
refs uses atomics, so its sums are taken in another order). The grid
kernels' distances
and positions are identical to their plain versions' (on rows with k
candidates), with and without the layout's real-row counts and under every
staging chunk, their interpolated values within rtol 1e-6 and
atol 1e-6 * max|v|. The packed kNN kernels' raw keys, decoded indices and
recomputed distances and the pruned pass kernel's state are identical to
their plain versions', NaN coordinates included; so are the f32-packed
kernel's keys built with every queries a thread Q and launched with every
cluster size S, and both pruned passes built with every S, at 1, 127, 2,500
and 90,000 rows x 30,000 refs for k = 1, 3, 9 and 16, and so are the
int-packed kernel's launched with every S. No kernel of the kNN family
takes a NaN distance, whatever its sign bit. The kNN, packed-key, grid and
pruned kernels past k = 16 and FPS past 65,536 points (their global-memory
variants) are identical to the plain versions too. The denoiser's residual
block kernel is held to its plain version by its error from the float32
block: at most 1.1x the plain version's, by max and by median.
"""

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import grid_knn, knn, min_sq_dist
from pointcloud_style_transfer_torch.ops.kernels import (
    LAUNCH_COUNTS, ball_query_cuda, ball_query_plain, fps_cuda, fps_plain,
    grid_interp_cuda, grid_interp_plain, grid_topk_cuda, grid_topk_plain,
    knn_f32packed, knn_f32packed_keys_cuda, knn_f32packed_keys_plain,
    knn_intpacked, knn_intpacked_keys_cuda, knn_intpacked_keys_plain,
    knn_pruned_pass_cuda, knn_pruned_pass_plain, knn_topk, knn_topk_cuda,
    knn_topk_plain, rowmin_cuda, rowmin_plain)
from pointcloud_style_transfer_torch.ops import pruned_knn
from pointcloud_style_transfer_torch.ops.kernels import _common, knn_packed
from pointcloud_style_transfer_torch.ops.kernels.knn import CLUSTER_SIZES

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def points(rng, b, n, dup_frac=0.1):
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    k = int(n * dup_frac)
    x[:, rng.choice(n, k, replace=False)] = x[:, rng.choice(n, k)]
    return x


@pytest.mark.parametrize("b,n,m,k", [(1, 5000, 3000, 3), (2, 1000, 2500, 1),
                                     (1, 700, 5, 8), (1, 300, 2, 3),
                                     (1, 3000, 5000, 9), (2, 1500, 2000, 16)])
def test_knn_kernel_matches_plain(rng, cuda, b, n, m, k):
    r = points(rng, b, m)
    q = points(rng, b, n)
    q[:, : n // 5] = r[:, rng.choice(m, n // 5)]  # zero-distance ties
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    before = LAUNCH_COUNTS["knn_topk"]
    d, i = knn_topk(qt, rt, k)
    assert LAUNCH_COUNTS["knn_topk"] == before + 1
    d_p, i_p = knn_topk_plain(qt, rt, k)
    assert torch.equal(i, i_p)
    rel = (d - d_p).abs() / d_p.abs().clamp(min=1e-30)
    assert rel.max().item() <= 1e-6


@pytest.mark.parametrize("b,n,npoint", [(1, 30000, 512), (2, 512, 128),
                                        (3, 1500, 200), (1, 40000, 64)])
def test_fps_kernel_matches_plain(rng, cuda, b, n, npoint):
    x = np.round(points(rng, b, n) * 8) / 8  # lattice: tied maxima
    xt = torch.from_numpy(x.astype(np.float32)).to(cuda)
    start = torch.from_numpy(rng.integers(0, n, b).astype(np.int32)).to(cuda)
    assert torch.equal(fps_cuda(xt, npoint, start),
                       fps_plain(xt, npoint, start))


# cluster sizes forced on the kNN kernel (None: the plan's)
KNN_PLANS = [None, 1, 2, 4, 8]


@pytest.mark.parametrize("plan", KNN_PLANS)
@pytest.mark.parametrize("b,n,m,k", [
    (1, 1, 30000, 3), (1, 100, 30000, 3), (1, 1825, 30000, 1),
    (1, 4096, 30000, 9), (2, 700, 3001, 16),  # B = 2; m not a multiple of
    (1, 300, 4099, 3),                        # the tile or of S
    (1, 200, 5, 8), (2, 64, 2, 3),            # m < k: fill slots, and
])                                            # empty ranks at m < S
def test_knn_kernel_plans_identical_to_plain(rng, cuda, b, n, m, k, plan):
    """Every plan gives the plain version's indices and distance bits, with
    zero-distance ties between the first and the last refs (the first and
    the last rank) and a NaN ref, never selected."""
    r = points(rng, b, m)
    tail = min(50, m // 2)
    r[:, m - tail:] = r[:, :tail]  # the same points at low and high indices
    q = points(rng, b, n)
    q[:, : n // 5] = r[:, rng.choice(tail, n // 5)] if tail else q[:, :0]
    nan_ref = m // 2 if m > 2 * tail else None
    if nan_ref is not None:
        r[0, nan_ref, 1] = np.nan
        r[0, nan_ref + 1, 0] = -np.nan  # the sign bit set
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    before = LAUNCH_COUNTS["knn_topk"]
    d, i = knn_topk_cuda(qt, rt, k, plan=plan)
    assert LAUNCH_COUNTS["knn_topk"] == before + 1
    d_p, i_p = knn_topk_plain(qt, rt, k)
    assert torch.equal(i, i_p)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
    if nan_ref is not None:
        assert not ((i[0] == nan_ref) | (i[0] == nan_ref + 1)).any()


@pytest.mark.parametrize("b,n,m,k", [
    (1, 2500, 30000, 17), (2, 700, 3001, 32), (1, 900, 5000, 64),
    (1, 300, 40, 64),  # k > M: fill slots
])
def test_knn_kernel_past_16_identical_to_plain(rng, cuda, b, n, m, k):
    """k > 16: the global-list kernel, one launch, indices and distance bits
    identical, with zero-distance ties and a NaN of each sign never
    taken."""
    r = points(rng, b, m)
    q = points(rng, b, n)
    q[:, : n // 5] = r[:, rng.choice(m, n // 5)]
    r[0, 3, 1] = np.nan
    r[0, 5, 2] = -np.nan
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    before = LAUNCH_COUNTS["knn_topk"]
    d, i = knn_topk(qt, rt, k)
    assert LAUNCH_COUNTS["knn_topk"] == before + 1
    d_p, i_p = knn_topk_plain(qt, rt, k)
    assert torch.equal(i, i_p)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
    taken = d[0] < 1e29
    assert not ((i[0] == 3) | (i[0] == 5))[taken].any()
    assert (d[..., 1:] >= d[..., :-1]).all()


@pytest.mark.parametrize("b,n,npoint,plan", [
    (1, 1, 4, None), (3, 1, 4, (4, 32, 1)),        # empty ranks
    (1, 7, 12, None), (3, 7, 12, (8, 32, 1)),      # npoint > n
    (1, 30000, 512, None), (3, 30000, 512, (4, 1024, 8)),
    (1, 30000, 512, (8, 1024, 4)), (3, 30000, 300, (8, 512, 8)),
    (1, 65536, 512, None), (3, 65536, 128, (8, 1024, 8)),
    # the streaming kernel (PER = 0): past the registers' 65,536 points,
    # and forced on small clouds
    (1, 70000, 64, None), (2, 70000, 32, (4, 512, 0)),
    (3, 1000, 50, (4, 256, 0)), (1, 7, 12, (2, 32, 0)),
])
def test_fps_kernel_plans_identical_to_plain(rng, cuda, b, n, npoint, plan):
    """Lattice clouds whose first half repeats in the second: tied maxima
    within a rank and across ranks."""
    x = np.round(points(rng, b, n) * 4) / 4
    half = n // 2
    x[:, half: 2 * half] = x[:, :half]
    xt = torch.from_numpy(x.astype(np.float32)).to(cuda)
    start = torch.from_numpy(rng.integers(0, n, b).astype(np.int32)).to(cuda)
    before = LAUNCH_COUNTS["fps"]
    got = fps_cuda(xt, npoint, start, plan=plan)
    assert LAUNCH_COUNTS["fps"] == before + 1
    assert torch.equal(got, fps_plain(xt, npoint, start))


def test_plans_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 4000, 3), device=cuda)
    start = torch.zeros(1, dtype=torch.int32, device=cuda)
    for plan in (0, 3, 16):
        with pytest.raises(ValueError):
            knn_topk_cuda(x, x, 3, plan=plan)
    for plan in ((1, 1024, 2), (2, 96, 8), (16, 256, 1), (1, 1024, 3)):
        with pytest.raises(ValueError):
            fps_cuda(x, 4, start, plan=plan)


@pytest.mark.parametrize("s,n,radius,ns", [(512, 30000, 0.2, 32),
                                           (128, 512, 0.4, 64),
                                           (300, 2000, 0.05, 16),
                                           (50, 20, 1.0, 40)])
def test_ball_query_kernel_matches_plain(rng, cuda, s, n, radius, ns):
    x = points(rng, 2, n) * 0.5
    c = np.concatenate([x[:, : s // 2],
                        points(rng, 2, s - s // 2, 0.0) * 2], axis=1)
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    assert torch.equal(ball_query_cuda(radius, ns, xt, ct),
                       ball_query_plain(radius, ns, xt, ct))


def edge_cloud(rng, b, n, hits):
    """Points inside radius 0.5 of the origin at the indices ``hits``, the
    others well outside; NaN coordinates of both signs set on the host (a
    -nan written on the card loses its sign bit)."""
    x = (rng.uniform(2.0, 4.0, (b, n, 3))
         * rng.choice([-1.0, 1.0], (b, n, 3))).astype(np.float32)
    sel = sorted(hits)
    x[:, sel] = rng.uniform(-0.2, 0.2, (b, len(sel), 3)).astype(np.float32)
    return x


# the source's (warps, steps a round) and its round of points
# (csrc/ball_query.cu)
BQ_PLAN = (_common.source_define("ball_query", "PCST_BQ_WARPS"),
           _common.source_define("ball_query", "PCST_BQ_UNROLL"))
BQ_ROUND = 32 * BQ_PLAN[0] * BQ_PLAN[1]
BQ_PLANS = [BQ_PLAN, (1, 1), (4, 2), (8, 8), (32, 1)]
# the row minimum's (S, Q): the source's, every other S at its Q, the other
# Q at its S (csrc/rowmin.cu)
ROWMIN_PLAN = (_common.source_define("rowmin", "PCST_ROWMIN_S"),
               _common.source_define("rowmin", "PCST_ROWMIN_Q"))
ROWMIN_PLANS = sorted(
    {(S, ROWMIN_PLAN[1]) for S in (1, 2, 4, 8)}
    | {(ROWMIN_PLAN[0], Q) for Q in (1, 2, 4, 8)})
# the pruned pass built for every cluster size (csrc/knn_pruned.cu), and at
# the source's with too little scratch for the longest-first order, so that
# every shape below takes the query tiles in their own order (nq + nr + 3 >
# 16); the f32-packed kernel's S is the launch's plan
PRUNED_PLANS = {f"S={S}": (f"-DPCST_PRUNED_S={S}",) for S in (1, 2, 4, 8)}
PRUNED_PLANS["own order"] = ("-DPCST_PRUNED_SCRATCH=16",)


@pytest.fixture(scope="module")
def variants():
    """The ball query, the row minimum and the pruned pass built with every
    plan above, all at once -> {(source, plan): library}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    bq = _common.build_variants("ball_query", {
        p: (f"-DPCST_BQ_WARPS={p[0]}", f"-DPCST_BQ_UNROLL={p[1]}")
        for p in BQ_PLANS})
    rm = _common.build_variants("rowmin", {
        p: (f"-DPCST_ROWMIN_S={p[0]}", f"-DPCST_ROWMIN_Q={p[1]}")
        for p in ROWMIN_PLANS})
    pr = _common.build_variants("knn_pruned", PRUNED_PLANS)
    return ({("ball_query", p): lib for p, lib in bq.items()}
            | {("rowmin", p): lib for p, lib in rm.items()}
            | {("knn_pruned", p): lib for p, lib in pr.items()})


@pytest.mark.parametrize("plan", BQ_PLANS)
@pytest.mark.parametrize("n,hits,ns", [
    (2 * BQ_ROUND + 5, set(), 32),                          # no hit
    (2 * BQ_ROUND + 77, {2 * BQ_ROUND + 3, 2 * BQ_ROUND + 76}, 8),  # last
    (3 * BQ_ROUND, set(range(BQ_ROUND - 32, BQ_ROUND)), 32),  # ends on a round
    (3 * BQ_ROUND, set(range(96, 128)), 32),                 # ends on a warp
    (2 * BQ_ROUND, set(range(120, 140)) | {BQ_ROUND - 1, BQ_ROUND}, 64),
    (20, {0, 7, 19}, 64),                                    # n < ns
    (BQ_ROUND + 33, set(range(0, BQ_ROUND + 33, 41)), 32),   # ragged round
])
def test_ball_query_kernel_rounds(rng, cuda, variants, n, hits, ns, plan):
    x = edge_cloud(rng, 3, n, hits)
    neg = np.copysign(np.float32(np.nan), np.float32(-1.0))
    if hits:
        h = sorted(hits)
        x[0, h[0], 1] = neg  # a hit that a NaN takes out, both signs
        x[1, h[-1], 0] = np.nan
    c = np.zeros((3, 2, 3), np.float32)
    c[2, 1, 2] = neg  # a NaN center: an empty row
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    before = LAUNCH_COUNTS["ball_query"]
    with _common.launching("ball_query", variants[("ball_query", plan)]):
        got = ball_query_cuda(0.5, ns, xt, ct)
    assert LAUNCH_COUNTS["ball_query"] == before + 1
    want = ball_query_plain(0.5, ns, xt, ct)
    assert torch.equal(got, want)
    assert (want[2, 1] == n).all()


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((1, 10, 3), device=cuda)
    with pytest.raises(ValueError):
        knn_topk_cuda(x.double(), x, 3)
    with pytest.raises(ValueError):
        knn_topk_cuda(x, x, 0)
    with pytest.raises(ValueError):
        knn_topk_cuda(x, x, 17, plan=2)  # past 16: no cluster
    with pytest.raises(ValueError):
        rowmin_cuda(x, x[:, :0])
    with pytest.raises(ValueError):
        rowmin_cuda(x[:, ::2], x)
    with pytest.raises(ValueError):
        knn_topk_cuda(x.cpu(), x, 3)
    with pytest.raises(ValueError):
        fps_cuda(x, 4, torch.zeros(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ball_query_cuda(0.1, 4, x[:, ::2], x)


@pytest.mark.parametrize("b,n,m", [(1, 30000, 30000), (2, 1030, 4100),
                                   (1, 64, 1)])
def test_rowmin_kernel_identical_to_plain(rng, cuda, b, n, m):
    r = points(rng, b, m)
    q = points(rng, b, n)
    q[:, : n // 5] = r[:, rng.choice(m, n // 5)]  # zero distances
    q[0, -1, 1] = np.nan  # a NaN query: its row only
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    before = LAUNCH_COUNTS["rowmin"]
    d = rowmin_cuda(qt, rt)
    assert LAUNCH_COUNTS["rowmin"] == before + 1
    d_p = rowmin_plain(qt, rt)
    nan = torch.isnan(d_p)
    assert torch.equal(torch.isnan(d), nan) and nan.sum().item() == 1
    assert torch.equal(d[~nan], d_p[~nan])
    assert (d[:, : n // 5] == 0).all()


@pytest.mark.parametrize("plan", ROWMIN_PLANS)
def test_rowmin_kernel_plans_identical_to_plain(rng, cuda, variants, plan):
    """Built with every (S, Q): a NaN ref in one rank's slice only (cloud
    0), a -nan query (cloud 1), rows at the 1e30 cap (cloud 2), Nq not a
    multiple of the 128 Q queries of a block; and M smaller than S."""
    b, n, m = 3, 517, 3000
    r = points(rng, b, m)
    q = points(rng, b, n)
    q[:, : n // 5] = r[:, rng.choice(m, n // 5)]
    S = plan[0]
    r[0, (S - 1) * -(-m // S) + 3, 2] = np.nan  # in the last rank's slice
    q[1, 100, 0] = np.copysign(np.float32(np.nan), np.float32(-1.0))
    q[2, :7] = 1e16  # every distance ~1e32: capped at 1e30
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    before = LAUNCH_COUNTS["rowmin"]
    with _common.launching("rowmin", variants[("rowmin", plan)]):
        d = rowmin_cuda(qt, rt)
        few = rt[:, :3].contiguous()  # fewer refs than slices
        d_few = rowmin_cuda(qt[2:], few[2:])
    assert LAUNCH_COUNTS["rowmin"] == before + 2
    d_p = rowmin_plain(qt, rt)
    nan = torch.isnan(d_p)
    assert nan[0].all() and nan[1].sum().item() == 1 and not nan[2].any()
    assert torch.equal(torch.isnan(d), nan)
    assert torch.equal(d[~nan], d_p[~nan])
    assert (d[2, :7] == np.float32(1e30)).all()
    assert torch.equal(d_few, rowmin_plain(qt[2:], few[2:]))


def test_min_sq_dist_kernels_and_grads(rng, cuda):
    """Under grad the forward is the k=1 kNN kernel (no row minimum);
    without, the row-min kernel; gradients within 1e-6 of the CPU's."""
    r = points(rng, 2, 3000)
    q = points(rng, 2, 2000)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 2000)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        qt = torch.from_numpy(q).to(dev).requires_grad_()
        rt = torch.from_numpy(r).to(dev).requires_grad_()
        before = dict(LAUNCH_COUNTS)
        val = torch.sum(w.to(dev) * min_sq_dist(qt, rt))
        val.backward()
        grads[str(dev)] = (val.item(), qt.grad.cpu(), rt.grad.cpu())
        if dev != "cpu":
            assert LAUNCH_COUNTS["knn_topk"] == before["knn_topk"] + 1
            assert LAUNCH_COUNTS["rowmin"] == before["rowmin"]
            with torch.no_grad():
                d = min_sq_dist(qt, rt)
            assert LAUNCH_COUNTS["rowmin"] == before["rowmin"] + 1
            assert LAUNCH_COUNTS["knn_topk"] == before["knn_topk"] + 1
            assert torch.equal(d, rowmin_plain(qt.detach(), rt.detach()))
    (v_c, dq_c, dr_c), (v_g, dq_g, dr_g) = grads["cpu"], grads[str(cuda)]
    assert v_g == pytest.approx(v_c, rel=1e-6)
    for got, want in ((dq_g, dq_c), (dr_g, dr_c)):
        tol = 1e-6 * want.abs().max().item()
        assert ((got - want).abs() <= tol + 1e-6 * want.abs()).all()


def grid_inputs(rng, cuda, m, nq, grid_shape, slot_cap, C=3):
    """Slot tables from the grid's own layout pass over a cloud with exact
    duplicates and queries on refs, plus a tile without candidates and one
    with a single candidate."""
    r = torch.from_numpy(points(rng, 1, m)[0]).to(cuda)
    q = torch.from_numpy(points(rng, 1, nq)[0]).to(cuda)
    q[: nq // 10] = r[: nq // 10]
    s = grid_knn._build_struct(r, grid_shape)
    sl = grid_knn._layout_slots(s, q, grid_shape, 128, slot_cap)
    st, en = sl.st.clone(), sl.en.clone()
    en[-1] = st[-1]
    en[-2] = st[-2]
    en[-2, 0] += 1
    vals = torch.from_numpy(rng.standard_normal((s.M_pad, C)).astype(
        np.float32)).to(cuda)
    return sl.q_pad, s.refs_pad, vals, st, en, sl.n_real


def check_grid_kernels(q, refs, vals, st, en, k, n_real=None):
    """Both grid kernels, one launch each, against the plain versions:
    distances identical on every row, positions on rows with k candidates,
    values within rtol 1e-6, atol 1e-6 * max|v|; returns (d, i)."""
    before = dict(LAUNCH_COUNTS)
    v, d = grid_interp_cuda(q, refs, vals, st, en, k, n_real=n_real)
    d_t, i_t = grid_topk_cuda(q, refs, st, en, k, n_real=n_real)
    assert LAUNCH_COUNTS["grid_interp"] == before["grid_interp"] + 1
    assert LAUNCH_COUNTS["grid_topk"] == before["grid_topk"] + 1
    v_p, d_p = grid_interp_plain(q, refs, vals, st, en, k, n_real=n_real)
    d_tp, i_tp = grid_topk_plain(q, refs, st, en, k, n_real=n_real)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(d_t.view(torch.int32), d_tp.view(torch.int32))
    full = d_p[:, -1] < 1e29
    assert full.any() and not full.all()
    assert torch.equal(i_t[full], i_tp[full])
    assert torch.isfinite(v).all()
    tol = 1e-6 * v_p[full].abs().max().item()
    assert ((v - v_p)[full].abs() <= tol + 1e-6 * v_p[full].abs()).all()
    return d_t, i_t


@pytest.mark.parametrize("with_n_real", [False, True])
@pytest.mark.parametrize("grid_shape,slot_cap,k,C", [
    ((16, 12, 8), 384, 3, 3),  # y-run slots, the sampler's config
    ((4, 4, 5), 128, 3, 2),    # windowed z-runs
    ((16, 12, 8), 384, 1, 3),
    ((16, 12, 8), 384, 8, 4)])
def test_grid_kernels_match_plain(rng, cuda, grid_shape, slot_cap, k, C,
                                  with_n_real):
    q, refs, vals, st, en, n_real = grid_inputs(rng, cuda, 6500, 9000,
                                                grid_shape, slot_cap, C)
    assert (n_real < 128).any() and (n_real == 0).any()  # padding to skip
    d, _ = check_grid_kernels(q, refs, vals, st, en, k,
                              n_real if with_n_real else None)
    if with_n_real:  # padding rows keep the start list
        pad = (torch.arange(128, device=cuda)[None, :]
               >= n_real[:, None]).reshape(-1)
        assert (d[pad] == 1e30).all()


@pytest.mark.parametrize("n_slots", [1, 3])
def test_grid_kernels_tiles_past_one_chunk(rng, cuda, n_slots):
    """Tiles of several staging chunks: every tile but the last (empty)
    one sees all of the grid's ~6,500 sorted refs in n_slots disjoint runs,
    so chunk boundaries fall inside the staging order's pieces."""
    q, refs, vals, _, _, n_real = grid_inputs(rng, cuda, 6500, 9000,
                                              (16, 12, 8), 384)
    T, M = n_real.shape[0], refs.shape[0]
    cuts = torch.linspace(0, M, n_slots + 1).round().int().to(cuda)
    st = cuts[:-1].expand(T, -1).contiguous()
    en = cuts[1:].expand(T, -1).contiguous()
    en[-1] = st[-1]
    check_grid_kernels(q, refs, vals, st, en, 3, n_real)
    check_grid_kernels(q, refs, vals, st, en, 8, n_real)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_grid_kernels_never_take_nan(rng, cuda, k):
    """A NaN ref of each sign inside the runs of many tiles: never taken,
    the lists ascending, everything else as the plain versions."""
    q, refs, vals, st, en, n_real = grid_inputs(rng, cuda, 6500, 9000,
                                                (16, 12, 8), 384)
    # set on the host: a -nan scalar written on the card loses its sign
    r = refs.cpu().numpy().copy()
    nan_pos = sorted({int(st[t, 0]) + 1 for t in range(0, 60, 3)})
    for j, p in enumerate(nan_pos):
        r[p, j % 3] = np.nan if j % 2 else -np.nan
    refs = torch.from_numpy(r).to(cuda)
    assert torch.signbit(refs[nan_pos[0], 0])
    d, i = check_grid_kernels(q, refs, vals, st, en, k, n_real)
    taken = d < 1e29
    assert not torch.isin(i, torch.tensor(nan_pos, device=cuda))[taken].any()
    assert (d[:, 1:] >= d[:, :-1]).all()


@pytest.mark.parametrize("tq", [1, 63, 64, 127, 1024])
def test_grid_kernels_any_tile_width(rng, cuda, tq):
    """Tiles of one row to 1,024 (partial warps, one thread a row), random
    disjoint runs in a shuffled slot order, with and without n_real."""
    r = torch.from_numpy(points(rng, 1, 3000)[0]).to(cuda)
    T = 5
    q = torch.from_numpy(points(rng, 1, T * tq)[0]).to(cuda)
    # four disjoint runs a tile, in a shuffled slot order
    st = (np.arange(4) * 700 + rng.integers(0, 200, (T, 4))).astype(np.int32)
    en = st + rng.integers(0, 500, (T, 4)).astype(np.int32)
    order = np.argsort(rng.random((T, 4)), axis=1)
    st = torch.from_numpy(np.take_along_axis(st, order, 1)).to(cuda)
    en = torch.from_numpy(np.take_along_axis(en, order, 1)).to(cuda)
    en[:, 1] = st[:, 1]  # an empty run
    vals = torch.randn((3000, 2), device=cuda)
    n_real = torch.from_numpy(rng.integers(0, tq + 1, T).astype(np.int32)
                              ).to(cuda)
    n_real[0] = tq
    for nr in (None, n_real):
        v, d = grid_interp_cuda(q, r, vals, st, en, 3, n_real=nr)
        d_t, i_t = grid_topk_cuda(q, r, st, en, 3, n_real=nr)
        v_p, d_p = grid_interp_plain(q, r, vals, st, en, 3, n_real=nr)
        d_tp, i_tp = grid_topk_plain(q, r, st, en, 3, n_real=nr)
        assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
        assert torch.equal(d_t, d_tp) and torch.equal(i_t, i_tp)
        full = d_p[:, -1] < 1e29
        tol = 1e-6 * v_p[full].abs().max().item() if full.any() else 0.0
        assert ((v - v_p)[full].abs() <= tol + 1e-6 * v_p[full].abs()).all()


@pytest.mark.parametrize("tq,k", [(512, 12), (513, 12), (1024, 16),
                                  (1024, 9)])
def test_grid_kernels_wide_tiles_past_8(rng, cuda, tq, k):
    """k = 9..16 on tiles of 512 rows (the interpolation's register lists)
    and wider (its global-list kernel), with and without n_real: both
    kernels identical to the plain versions."""
    r = torch.from_numpy(points(rng, 1, 3000)[0]).to(cuda)
    T = 3
    q = torch.from_numpy(points(rng, 1, T * tq)[0]).to(cuda)
    st = torch.tensor([[0, 1200], [300, 2000], [100, 100]], dtype=torch.int32,
                      device=cuda)
    en = st + torch.tensor([[900, 700], [800, 900], [0, 5]],
                           dtype=torch.int32, device=cuda)
    vals = torch.randn((3000, 2), device=cuda)
    n_real = torch.tensor([tq, tq // 2, 7], dtype=torch.int32, device=cuda)
    for nr in (None, n_real):
        v, d = grid_interp_cuda(q, r, vals, st, en, k, n_real=nr)
        d_t, i_t = grid_topk_cuda(q, r, st, en, k, n_real=nr)
        v_p, d_p = grid_interp_plain(q, r, vals, st, en, k, n_real=nr)
        d_tp, i_tp = grid_topk_plain(q, r, st, en, k, n_real=nr)
        assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
        assert torch.equal(d_t, d_tp) and torch.equal(i_t, i_tp)
        full = d_p[:, -1] < 1e29
        tol = 1e-6 * v_p[full].abs().max().item()
        assert ((v - v_p)[full].abs() <= tol + 1e-6 * v_p[full].abs()).all()


def test_grid_paths_launch_kernels(rng, cuda):
    r = torch.from_numpy(points(rng, 1, 6500)).to(cuda)
    q = torch.from_numpy(points(rng, 1, 9000)).to(cuda)
    v = torch.randn((6500, 3), device=cuda)
    before = dict(LAUNCH_COUNTS)
    v_lay, qid = grid_knn.grid_knn_interpolate_layout(q[0], r[0], v)
    assert LAUNCH_COUNTS["grid_interp"] == before["grid_interp"] + 1
    d_g, i_g = knn(q, r, 3, backend="grid")
    assert LAUNCH_COUNTS["grid_topk"] == before["grid_topk"] + 1
    d_b, i_b = knn_topk(q, r, 3)
    assert torch.equal(d_g, d_b)
    real = qid < 9000
    assert torch.equal(torch.sort(qid[real].long()).values,
                       torch.arange(9000, device=cuda))


def test_grid_batched_layout_matches_plain(rng, cuda):
    """The flat-batched layout of three clouds of different densities: one
    launch over every cloud's tiles, each tile's runs inside its own
    cloud's part of the refs, against the plain versions; the entry point
    launches grid_interp once for the batch, and each cloud gets its own
    pass's layout order and values."""
    scales = np.array([0.3, 1.0, 3.0], np.float32)[:, None, None]
    r = torch.from_numpy(points(rng, 3, 6500) * scales).to(cuda)
    q = torch.from_numpy(points(rng, 3, 9000) * scales).to(cuda)
    v = torch.randn((3, 6500, 3), device=cuda)
    sb = grid_knn._build_struct_batched(r, (16, 12, 8))
    sl = grid_knn._layout_slots(sb, q, (16, 12, 8), 128, 384)
    lo = sl.tb[:, None] * sb.M_pad
    busy = sl.en > sl.st
    assert (((sl.st >= lo) & (sl.en <= lo + sb.M)) | ~busy).all()
    check_grid_kernels(sl.q_pad, sb.refs_pad,
                       grid_knn._sorted_values(sb, v), sl.st, sl.en, 3,
                       sl.n_real)
    before = dict(LAUNCH_COUNTS)
    v_lay, qid = grid_knn.grid_knn_interpolate_layout_batched(q, r, v)
    assert LAUNCH_COUNTS["grid_interp"] == before["grid_interp"] + 1
    assert LAUNCH_COUNTS["knn_topk"] <= before["knn_topk"] + 1
    for b in range(3):
        v1, qid1 = grid_knn.grid_knn_interpolate_layout(q[b], r[b], v[b])
        mine = (qid >= b * 9000) & (qid < (b + 1) * 9000)
        assert torch.equal(qid[mine] - b * 9000, qid1[qid1 < 9000])
        want = v1[qid1 < 9000]
        tol = 1e-6 * want.abs().max().item()
        assert ((v_lay[mine] - want).abs() <= tol + 1e-6 * want.abs()).all()


def test_strip_patch_matches_plain(rng, cuda, monkeypatch):
    """``_strip_interp_patch``: one grid_interp launch for its tiles, ids,
    fail flags and values those of its plain run."""
    r = torch.from_numpy(points(rng, 1, 6500)[0]).to(cuda)
    q = torch.from_numpy(points(rng, 1, 9000)[0]).to(cuda)
    v = torch.randn((6500, 3), device=cuda)
    s = grid_knn._build_struct(r, (16, 12, 8))
    vals = grid_knn._sorted_values(s, v)
    ids = torch.cat([torch.from_numpy(rng.choice(9000, 1000, replace=False)),
                     torch.full((24,), 9000)]).int().to(cuda)
    before = LAUNCH_COUNTS["grid_interp"]
    got = grid_knn._strip_interp_patch(s, (16, 12, 8), q, ids, vals, 3, 1e-8)
    assert LAUNCH_COUNTS["grid_interp"] == before + 1
    monkeypatch.setattr(grid_knn, "grid_interp", grid_interp_plain)
    ids_p, v_p, fail_p = grid_knn._strip_interp_patch(s, (16, 12, 8), q, ids,
                                                      vals, 3, 1e-8)
    assert torch.equal(got[0], ids_p) and torch.equal(got[2], fail_p)
    real = ids_p < 9000
    want = v_p[real]
    tol = 1e-6 * want.abs().max().item()
    assert ((got[1][real] - want).abs() <= tol + 1e-6 * want.abs()).all()


def test_grid_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((256, 3), device=cuda)
    refs = torch.zeros((128, 3), device=cuda)
    vals = torch.zeros((128, 3), device=cuda)
    st = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    grid_topk_cuda(q, refs, st, st, 3)  # accepted
    with pytest.raises(ValueError):
        grid_topk_cuda(q.double(), refs, st, st, 3)
    with pytest.raises(ValueError):
        grid_topk_cuda(q, refs, st, st, 0)
    with pytest.raises(ValueError):
        grid_topk_cuda(q, refs, st.long(), st, 3)
    with pytest.raises(ValueError):
        grid_topk_cuda(q, refs.cpu(), st, st, 3)
    with pytest.raises(ValueError):
        grid_topk_cuda(q[:255], refs, st, st, 3)  # not 2 equal tiles
    with pytest.raises(ValueError):
        grid_topk_cuda(torch.zeros((2050, 3), device=cuda), refs, st, st,
                       3)  # 1025 queries a tile
    with pytest.raises(ValueError):
        grid_topk_cuda(q, refs, st, st[:, :2], 3)
    with pytest.raises(ValueError):
        grid_interp_cuda(q, refs, vals[:64], st, st, 3)
    with pytest.raises(ValueError):
        grid_interp_cuda(q, refs, vals.t(), st, st, 3)
    n_real = torch.zeros(2, dtype=torch.int32, device=cuda)
    grid_topk_cuda(q, refs, st, st, 3, n_real=n_real)  # accepted
    with pytest.raises(ValueError):
        grid_topk_cuda(q, refs, st, st, 3, n_real=n_real[:1])
    with pytest.raises(ValueError):
        grid_topk_cuda(q, refs, st, st, 3, n_real=n_real.long())


@pytest.mark.parametrize("b,n,m,k,tr", [
    (1, 5000, 3000, 3, 4096), (2, 1000, 2500, 1, 2048), (1, 700, 5, 8, 2048),
    (1, 300, 2, 3, 4096), (1, 3000, 5000, 9, 512), (2, 1500, 2048, 16, 2048),
    (1, 200, 32768, 3, 4096)])
def test_packed_knn_kernels_match_plain(rng, cuda, b, n, m, k, tr):
    r = points(rng, b, m)
    q = points(rng, b, n)
    q[:, : n // 5] = r[:, rng.choice(m, n // 5)]  # zero distances
    q[0, -1, 1] = np.nan  # a NaN query keeps the start keys
    r[0, 0, 2] = np.nan   # a NaN ref is never selected,
    if m > 2:
        r[0, 1, 0] = -np.nan  # whatever its sign bit
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    m_total = -(-m // tr) * tr
    for name, kernel, plain, whole in (
            ("knn_f32packed", knn_f32packed_keys_cuda,
             knn_f32packed_keys_plain, knn_f32packed),
            ("knn_packed", knn_intpacked_keys_cuda, knn_intpacked_keys_plain,
             knn_intpacked)):
        before = LAUNCH_COUNTS[name]
        keys = kernel(qt, rt, k, m_total)
        assert LAUNCH_COUNTS[name] == before + 1
        assert torch.equal(keys.view(torch.int32),
                           plain(qt, rt, k, m_total).view(torch.int32))
        d, i = whole(qt, rt, k, tr=tr)
        d_c, i_c = whole(qt.cpu(), rt.cpu(), k, tr=tr)
        assert torch.equal(i.cpu(), i_c)
        nan = torch.isnan(d_c)
        assert torch.equal(torch.isnan(d).cpu(), nan) and nan[0, -1].all()
        assert torch.equal(d.cpu()[~nan], d_c[~nan])
        assert not (i[0, :-1] == 0).any()
        if m > 2:
            assert not (i[0, :-1] == 1).any()


NEG_NAN = np.copysign(np.float32(np.nan), np.float32(-1.0))


@pytest.fixture(scope="module")
def sampler_clouds():
    """90,000 queries and 30,000 refs (the sampler's upsample) with exact
    duplicates and queries on refs, NaN refs in the first and the last
    slice and NaN queries, both signs, set on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    rng = np.random.default_rng(8)
    r = points(rng, 1, 30000)
    q = points(rng, 1, 90000)
    q[:, 300:3000] = r[:, rng.choice(30000, 2700)]
    r[0, 7, 1] = NEG_NAN
    r[0, 29990, 0] = np.nan
    q[0, 60, 2] = NEG_NAN
    q[0, 100, 0] = np.nan
    return (torch.from_numpy(q).to("cuda"), torch.from_numpy(r).to("cuda"))


@pytest.mark.parametrize("k", [1, 3, 9, 16])
@pytest.mark.parametrize("rows", [1, 127, 2500, 90000])
def test_f32packed_every_plan_identical_to_plain(cuda, sampler_clouds,
                                                 rows, k):
    """The f32-packed kernel launched with every S: raw keys identical to
    the plain version's at the sampler's and the grid patch's shapes (the
    patch's refs padded to its 2,048 tile)."""
    q, r = sampler_clouds
    q = q[:, :rows].contiguous()
    m_total = knn_packed.padded_refs(r.shape[1], 2048 if rows == 2500
                                     else 4096)
    want = knn_f32packed_keys_plain(q, r, k, m_total).view(torch.int32)
    before = LAUNCH_COUNTS["knn_f32packed"]
    for S in CLUSTER_SIZES:
        got = knn_f32packed_keys_cuda(q, r, k, m_total, plan=S)
        assert torch.equal(got.view(torch.int32), want), S
    assert LAUNCH_COUNTS["knn_f32packed"] == before + len(CLUSTER_SIZES)
    if rows > 100:
        assert (want[0, [60, 100]] == 0x7149F2CA).all()  # NaN rows: start
    idx = want & 0x7FFF
    assert not ((idx == 7) | (idx == 29990)).any()


@pytest.mark.parametrize("k", [1, 3, 9, 16])
@pytest.mark.parametrize("rows", [1, 127, 2500, 90000])
def test_intpacked_every_plan_identical_to_plain(cuda, sampler_clouds,
                                                 rows, k):
    """The int-packed kernel launched with every S: raw keys identical to
    the plain version's at the sampler's and the grid patch's shapes (the
    refs padded to the TPU wrapper's 2,048 tile: idx_bits 15), with NaN refs
    and queries of both signs."""
    q, r = sampler_clouds
    q = q[:, :rows].contiguous()
    m_total = knn_packed.padded_refs(r.shape[1], 2048)
    want = knn_intpacked_keys_plain(q, r, k, m_total)
    before = LAUNCH_COUNTS["knn_packed"]
    for S in CLUSTER_SIZES:
        got = knn_intpacked_keys_cuda(q, r, k, m_total, plan=S)
        assert torch.equal(got, want), S
    assert LAUNCH_COUNTS["knn_packed"] == before + len(CLUSTER_SIZES)
    if rows > 100:  # NaN rows: start keys (the padding refs are NaN too)
        assert (want[0, [60, 100]] == 1 << 30).all()
    idx = want & 0x7FFF
    assert not ((idx == 7) | (idx == 29990)).any()


@pytest.mark.parametrize("m,m_total,k", [(5, 8, 8), (37, 64, 3),
                                         (1100, 2048, 16), (900, 1000, 9)])
def test_intpacked_every_plan_few_refs_and_idx_bits(rng, cuda, m, m_total,
                                                    k):
    """Slices shorter than k, empty slices (M < S), padding refs, and
    idx_bits below 15 (the filter's bound passes 32 bits at the start key);
    infinite distances (far refs), taken while fewer than k others are
    left."""
    r = points(rng, 2, m)
    q = points(rng, 2, 300)
    q[:, :50] = r[:, rng.choice(m, 50)]
    r[0, -3:] = 3e19  # squared distances past float32: infinite
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    want = knn_intpacked_keys_plain(qt, rt, k, m_total)
    for S in CLUSTER_SIZES:
        assert torch.equal(knn_intpacked_keys_cuda(qt, rt, k, m_total,
                                                   plan=S), want), S


@pytest.mark.parametrize("k", [17, 32])
def test_packed_kernels_past_16_identical_to_plain(cuda, sampler_clouds, k):
    """Both packed-key kernels past the register lists (their global-list
    kernels, no cluster) at 127, 2,500 and 90,000 rows: one launch, raw keys
    identical to the plain versions', NaN of both signs included; and with
    fewer refs than k (padding refs, start keys)."""
    q, r = sampler_clouds
    small = r[:, :9].contiguous()
    for name, kernel, plain in (
            ("knn_f32packed", knn_f32packed_keys_cuda,
             knn_f32packed_keys_plain),
            ("knn_packed", knn_intpacked_keys_cuda, knn_intpacked_keys_plain)):
        for rows, ref, m_total in ((127, r, 30720), (2500, r, 30720),
                                   (90000, r, 32768), (2500, small, 20)):
            qq = q[:, :rows].contiguous()
            before = LAUNCH_COUNTS[name]
            got = kernel(qq, ref, k, m_total)
            assert LAUNCH_COUNTS[name] == before + 1
            want = plain(qq, ref, k, m_total)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (name, rows)


@pytest.mark.parametrize("k", [17, 32])
def test_grid_kernels_past_16_identical_to_plain(rng, cuda, k):
    """The grid kernels' global-list variants on the grid's own tables,
    with and without n_real, with a NaN ref of each sign: distances
    identical, positions on rows with k candidates, values within rtol
    1e-6, atol 1e-6 * max|v|."""
    q, refs, vals, st, en, n_real = grid_inputs(rng, cuda, 6500, 9000,
                                                (16, 12, 8), 384)
    r = refs.cpu().numpy().copy()
    r[int(st[3, 0]) + 1, 0] = NEG_NAN
    r[int(st[9, 0]) + 1, 1] = np.nan
    refs = torch.from_numpy(r).to(cuda)
    for nr in (None, n_real):
        d, i = check_grid_kernels(q, refs, vals, st, en, k, nr)
        assert (d[:, 1:] >= d[:, :-1]).all()


@pytest.mark.parametrize("k", [17, 32])
def test_pruned_pass_past_16_identical_to_plain(cuda, sampler_clouds, k):
    """Both pruned passes at k past 16 (the global-list kernel) at 90,000 x
    30,000, default tiles, NaN refs and queries of both signs: state
    identical to the plain version's, one launch a pass, the whole call's
    distances those of the brute-force kernel."""
    q, r = sampler_clouds
    qs, rs, _, _ = pruned_knn.sort_and_pad(q[0], r[0], 512, 2048)
    nq, nr = qs.shape[0] // 512, rs.shape[0] // 2048
    in_window = pruned_knn.window_mask(nq, nr, 2, cuda)
    state = (qs.new_full((qs.shape[0], k), 1e30),
             torch.zeros((qs.shape[0], k), dtype=torch.int32, device=cuda))
    skip = (~in_window).int().contiguous()
    for _ in range(2):
        before = LAUNCH_COUNTS["knn_pruned"]
        d, i = knn_pruned_pass_cuda(qs, rs, skip, *state, k, 512, 2048)
        assert LAUNCH_COUNTS["knn_pruned"] == before + 1
        d_p, i_p = knn_pruned_pass_plain(qs, rs, skip, *state, k, 512, 2048)
        assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
        assert torch.equal(i, i_p)
        skip = (pruned_knn.prune_mask(qs, rs, d, k, 512, 2048)
                | in_window).int().contiguous()
        state = (d, i)
    # the whole call, on rows and refs without NaN
    qq, rr = q[:, 3000:8000].contiguous(), r[:, 8:29990].contiguous()
    d, _ = knn(qq, rr, k, backend="pallas_pruned")
    assert torch.equal(d, knn_topk(qq, rr, k)[0])


@pytest.mark.parametrize("m,k", [(5, 8), (37, 3), (1100, 16)])
def test_f32packed_every_plan_few_refs(rng, cuda, m, k):
    """Slices shorter than k, empty slices (M < S) and padding refs."""
    r = points(rng, 2, m)
    q = points(rng, 2, 300)
    q[:, :50] = r[:, rng.choice(m, 50)]
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    want = knn_f32packed_keys_plain(qt, rt, k, 2048).view(torch.int32)
    for S in CLUSTER_SIZES:
        got = knn_f32packed_keys_cuda(qt, rt, k, 2048, plan=S)
        assert torch.equal(got.view(torch.int32), want), S


@pytest.mark.parametrize("k", [1, 3, 9, 16])
@pytest.mark.parametrize("rows", [1, 127, 2500, 90000])
def test_pruned_every_cluster_size_identical_to_plain(
        cuda, variants, sampler_clouds, rows, k):
    """The pruned pass built for every S (and with the query tiles in
    their own order), both passes at the default tiles
    (512 x 2,048): state identical to the plain version's, with NaN refs and
    queries of both signs, and a second skip matrix with a row of every
    tile skipped, a row of none and a row of one tile."""
    q, r = sampler_clouds
    ok = ~torch.isnan(q[0]).any(1)
    ok[rows:] = False
    qs, rs, _, _ = pruned_knn.sort_and_pad(q[0][ok], r[0, 8:29990], 512,
                                           2048)
    qs_h, rs_h = qs.cpu().numpy(), rs.cpu().numpy()
    rs_h[7, 1], rs_h[20000, 0] = NEG_NAN, np.nan  # set on the host
    if rows > 100:
        qs_h[60, 2], qs_h[100, 0] = NEG_NAN, np.nan
    qs, rs = torch.from_numpy(qs_h).to(cuda), torch.from_numpy(rs_h).to(cuda)
    nq, nr = qs.shape[0] // 512, rs.shape[0] // 2048
    in_window = pruned_knn.window_mask(nq, nr, 2, cuda)
    d0 = qs.new_full((qs.shape[0], k), 1e30)
    i0 = torch.zeros((qs.shape[0], k), dtype=torch.int32, device=cuda)
    skip1 = (~in_window).int().contiguous()
    d1, i1 = knn_pruned_pass_plain(qs, rs, skip1, d0, i0, k, 512, 2048)
    skip2 = (pruned_knn.prune_mask(qs, rs, d1, k, 512, 2048)
             | in_window).int()
    skip2[0] = 1
    skip2[-1] = 0
    if nq > 2:
        skip2[1] = 1
        skip2[1, nr // 2] = 0
    skip2 = skip2.contiguous()
    d2, i2 = knn_pruned_pass_plain(qs, rs, skip2, d1, i1, k, 512, 2048)
    before = LAUNCH_COUNTS["knn_pruned"]
    for plan in PRUNED_PLANS:
        with _common.launching("knn_pruned", variants[("knn_pruned", plan)]):
            for skip, di, ii, dw, iw in ((skip1, d0, i0, d1, i1),
                                         (skip2, d1, i1, d2, i2)):
                d, i = knn_pruned_pass_cuda(qs, rs, skip, di, ii, k, 512,
                                            2048)
                assert torch.equal(d.view(torch.int32),
                                   dw.view(torch.int32)), plan
                assert torch.equal(i, iw), plan
    assert LAUNCH_COUNTS["knn_pruned"] == before + 2 * len(PRUNED_PLANS)
    if rows > 100:
        assert (d2[[60, 100]] == np.float32(1e30)).all()
    assert not ((i2 == 7) | (i2 == 20000)).any()


def test_packed_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((1, 10, 3), device=cuda)
    big = torch.zeros((1, 32769, 3), device=cuda)
    for kernel in (knn_f32packed_keys_cuda, knn_intpacked_keys_cuda):
        for plan in (0, 3, 16):
            with pytest.raises(ValueError):
                kernel(x, x, 3, 2048, plan=plan)
        kernel(x, x, 3, 2048)  # accepted
        kernel(x, x, 17, 2048)  # accepted: the global lists
        with pytest.raises(ValueError):
            kernel(x, big, 3, 32769)
        with pytest.raises(ValueError):
            kernel(x, x, 0, 2048)
        with pytest.raises(ValueError):
            kernel(x, x, 17, 2048, plan=2)  # past 16: no cluster
        with pytest.raises(ValueError):
            kernel(x, x, 3, 5)  # fewer padded refs than refs
        with pytest.raises(ValueError):
            kernel(x.cpu(), x, 3, 2048)


@pytest.mark.parametrize("n,m,k,tq,tr", [(5000, 3000, 3, 512, 2048),
                                         (1000, 900, 9, 128, 256),
                                         (300, 700, 1, 100, 300),
                                         (2000, 2000, 16, 512, 2048)])
def test_pruned_pass_kernel_matches_plain(rng, cuda, n, m, k, tq, tr):
    """Both passes of the pruned kNN on Morton-sorted clustered clouds with
    duplicates: running state identical to the plain version's; the whole
    call identical to the CPU's and its distances to the brute force's."""
    r = points(rng, 1, m)[0] * 0.05 + rng.integers(-3, 4, (m, 1)) * 5.0
    q = points(rng, 1, n)[0] * 0.05 + rng.integers(-3, 4, (n, 1)) * 5.0
    q[: n // 5] = r[rng.choice(m, n // 5)]
    qt = torch.from_numpy(q.astype(np.float32)).to(cuda)
    rt = torch.from_numpy(r.astype(np.float32)).to(cuda)
    qs, rs, _, _ = pruned_knn.sort_and_pad(qt, rt, tq, tr)
    nq, nr = qs.shape[0] // tq, rs.shape[0] // tr
    in_window = pruned_knn.window_mask(nq, nr, 2, cuda)
    d0 = qs.new_full((qs.shape[0], k), 1e30)
    i0 = torch.zeros((qs.shape[0], k), dtype=torch.int32, device=cuda)
    skip1 = (~in_window).int().contiguous()
    before = LAUNCH_COUNTS["knn_pruned"]
    d1, i1 = knn_pruned_pass_cuda(qs, rs, skip1, d0, i0, k, tq, tr)
    d1_p, i1_p = knn_pruned_pass_plain(qs, rs, skip1, d0, i0, k, tq, tr)
    assert torch.equal(d1, d1_p) and torch.equal(i1, i1_p)
    skip2 = (pruned_knn.prune_mask(qs, rs, d1, k, tq, tr)
             | in_window).int().contiguous()
    d2, i2 = knn_pruned_pass_cuda(qs, rs, skip2, d1, i1, k, tq, tr)
    assert LAUNCH_COUNTS["knn_pruned"] == before + 2
    d2_p, i2_p = knn_pruned_pass_plain(qs, rs, skip2, d1, i1, k, tq, tr)
    assert torch.equal(d2, d2_p) and torch.equal(i2, i2_p)

    d, i = pruned_knn._pruned_knn_single(qt, rt, k, tq, tr)
    d_c, i_c = pruned_knn._pruned_knn_single(qt.cpu(), rt.cpu(), k, tq, tr)
    assert torch.equal(d.cpu(), d_c) and torch.equal(i.cpu(), i_c)
    assert torch.equal(d[None], knn_topk(qt[None], rt[None], k)[0])


def test_pruned_pass_nan_and_bad_inputs(rng, cuda):
    q = torch.from_numpy(points(rng, 1, 256)[0]).to(cuda)
    r = torch.from_numpy(points(rng, 1, 512)[0]).to(cuda)
    q[5, 0] = float("nan")
    r[7, 1] = float("nan")
    skip = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    d0 = q.new_full((256, 3), 1e30)
    i0 = torch.zeros((256, 3), dtype=torch.int32, device=cuda)
    d, i = knn_pruned_pass_cuda(q, r, skip, d0, i0, 3, 128, 256)
    d_p, i_p = knn_pruned_pass_plain(q, r, skip, d0, i0, 3, 128, 256)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    assert torch.equal(d[5], d0[5]) and not (i == 7).any()
    with pytest.raises(ValueError):
        knn_pruned_pass_cuda(q[:200], r, skip, d0[:200], i0[:200], 3, 128, 256)
    with pytest.raises(ValueError):
        knn_pruned_pass_cuda(q, r, skip.long(), d0, i0, 3, 128, 256)
    with pytest.raises(ValueError):
        knn_pruned_pass_cuda(q, r, skip[:1], d0, i0, 3, 128, 256)
    with pytest.raises(ValueError):
        knn_pruned_pass_cuda(q, r, skip, d0, i0.cpu(), 3, 128, 256)


def test_new_knn_backends_launch_their_kernels(rng, cuda):
    r = torch.from_numpy(points(rng, 1, 6500)).to(cuda)
    q = torch.from_numpy(points(rng, 1, 9000)).to(cuda)
    d_b, i_b = knn_topk(q, r, 3)
    before = dict(LAUNCH_COUNTS)
    d, _ = knn(q, r, 3, backend="pallas_pruned")
    assert LAUNCH_COUNTS["knn_pruned"] == before["knn_pruned"] + 2
    assert torch.equal(d, d_b)
    d, _ = knn(q, r, 3, backend="pallas_f32packed")
    assert LAUNCH_COUNTS["knn_f32packed"] == before["knn_f32packed"] + 1
    assert (d >= d_b).all() and (d <= d_b * (1 + 2.0 ** -8) + 1e-37).all()
    d, _ = grid_knn.grid_knn(q, r, 3, exact=False)
    assert LAUNCH_COUNTS["grid_topk"] == before["grid_topk"] + 1
    assert LAUNCH_COUNTS["knn_topk"] == before["knn_topk"]
    assert (d >= d_b).all() and (d <= d_b * (1 + 2.0 ** -8) + 1e-37).all()


@pytest.mark.parametrize("S", CLUSTER_SIZES)
@pytest.mark.parametrize("counts", [(0, 0), (4100, 4100), (401, 0),
                                    (128 * 3 + 17, 2500), (1, 129)])
def test_knn_count_on_device_identical_to_plain(rng, cuda, S, counts):
    """``knn_topk`` with ``row_ids`` and a per-cloud count on the card: the
    plain twin's rows, distance bits included, below each count, the start
    list past it, under every cluster size S; counts of 0, the whole
    buffer, and counts that end inside a cluster's query block."""
    q = torch.from_numpy(points(rng, 2, 6000)).to(cuda)
    r = torch.from_numpy(points(rng, 2, 3000)).to(cuda)
    ids = torch.from_numpy(np.stack([rng.permutation(6000)[:4100]
                                     for _ in range(2)]).astype(np.int32))
    ids = ids.to(cuda).contiguous()
    count = torch.tensor(counts, dtype=torch.int32, device=cuda)
    for k in (3, 16):
        d, i = knn_topk_cuda(q, r, k, plan=S, row_ids=ids, count=count)
        d_p, i_p = knn_topk_plain(q, r, k, ids, count)
        assert torch.equal(i, i_p)
        assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))


def test_knn_count_on_device_past_16(rng, cuda):
    q = torch.from_numpy(points(rng, 2, 3000)).to(cuda)
    r = torch.from_numpy(points(rng, 2, 2000)).to(cuda)
    ids = torch.from_numpy(np.stack([rng.permutation(3000)[:1000]
                                     for _ in range(2)]).astype(np.int32))
    count = torch.tensor([300, 1000], dtype=torch.int32, device=cuda)
    d, i = knn_topk_cuda(q, r, 17, row_ids=ids.to(cuda), count=count)
    d_p, i_p = knn_topk_plain(q, r, 17, ids.to(cuda), count)
    assert torch.equal(i, i_p) and torch.equal(d, d_p)


@pytest.mark.parametrize("S", CLUSTER_SIZES)
@pytest.mark.parametrize("counts", [(0, 0), (4100, 4100), (401, 0),
                                    (128 * 3 + 17, 2500), (1, 129)])
def test_f32packed_count_on_device_identical_to_plain(rng, cuda, S, counts):
    """The f32-packed kernel with ``row_ids`` and a per-cloud count (the
    kd-grid's inexact fallback): the plain twin's keys below each count,
    the start keys past it, under every cluster size S, and in the
    global-list variant (k = 17, S = 1)."""
    q = torch.from_numpy(points(rng, 2, 6000)).to(cuda)
    r = torch.from_numpy(points(rng, 2, 3000)).to(cuda)
    ids = torch.from_numpy(np.stack([rng.permutation(6000)[:4100]
                                     for _ in range(2)]).astype(np.int32))
    ids = ids.to(cuda).contiguous()
    count = torch.tensor(counts, dtype=torch.int32, device=cuda)
    for k, plan in ((3, S), (16, S), (17, 1)):
        before = LAUNCH_COUNTS["knn_f32packed"]
        keys = knn_f32packed_keys_cuda(q, r, k, 4096, plan=plan, row_ids=ids,
                                       count=count)
        assert LAUNCH_COUNTS["knn_f32packed"] == before + 1
        want = knn_f32packed_keys_plain(q, r, k, 4096, ids, count)
        assert torch.equal(keys.view(torch.int32), want.view(torch.int32))


def test_sampler_captured_matches_eager(cuda, monkeypatch):
    """A small guided_sample_loop on the grid (a (2, 2, 2) grid, so that
    2,048 / 512 points engage it) through the capture runner: its first
    (eager) call, its second (captured, then replayed) and a third
    (replayed) identical to the eager body on the same draws, with the
    same launch counts each."""
    import functools
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, capture, guided_sample_loop, make_schedule,
        samplers)
    grid = dict(grid_shape=(2, 2, 2), tq=64, slot_cap=256)
    monkeypatch.setattr(grid_knn, "grid_knn_interpolate_layout",
                        functools.partial(
                            grid_knn.grid_knn_interpolate_layout, **grid))
    torch.manual_seed(0)
    cfg = Config(total_points=2048, global_points=512, feature_dim=32,
                 time_embed_dim=16, use_amp=False, knn_backend="grid")
    model = PointCloudDiffusionModel(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    src, cond, x0 = (torch.randn((1, 2048, 3), generator=gen, device=cuda)
                     for _ in range(3))
    draws = dict(x_init=x0, step_priorities=torch.rand(
        (5, 1, 2048), generator=gen, device=cuda),
        cond_priority=torch.rand((1, 2048), generator=gen, device=cuda),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64, device=cuda))

    def run():
        return guided_sample_loop(model, make_schedule(cfg), src, cond, 5,
                                  **draws)
    n_cap = len(capture.CAPTURES)
    counts = []
    outs = []
    for _ in range(3):  # eager (the warm-up), captured + replayed, replayed
        before = dict(LAUNCH_COUNTS)
        outs.append(run())
        torch.cuda.synchronize()
        counts.append({k: v - before[k] for k, v in LAUNCH_COUNTS.items()})
        assert len(capture.CAPTURES) == n_cap + (len(outs) > 1)
    # the launches a replay makes are counted as the eager call's
    assert counts[0]["grid_interp"] == 5 and counts[1] == counts[2] == counts[0]
    monkeypatch.setattr(samplers, "run_captured",
                        lambda key, body, inputs, owner, **kw: body(inputs))
    eager = run()
    assert all(torch.equal(o, eager) for o in outs)


def test_pruned_sampler_captured_matches_eager(cuda, monkeypatch):
    """``guided_sample_loop`` on ``"pallas_pruned"`` (two pruned passes a
    step, no host read) through the capture runner: its first (eager),
    second (captured, then replayed) and third (replayed) calls identical
    to the eager body on the same draws, with the same launches each."""
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, capture, guided_sample_loop, make_schedule,
        samplers)
    torch.manual_seed(0)
    cfg = Config(total_points=2048, global_points=512, feature_dim=32,
                 time_embed_dim=16, use_amp=False,
                 knn_backend="pallas_pruned")
    model = PointCloudDiffusionModel(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    src, cond, x0 = (torch.randn((1, 2048, 3), generator=gen, device=cuda)
                     for _ in range(3))
    draws = dict(x_init=x0, step_priorities=torch.rand(
        (5, 1, 2048), generator=gen, device=cuda),
        cond_priority=torch.rand((1, 2048), generator=gen, device=cuda),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64, device=cuda))

    def run():
        return guided_sample_loop(model, make_schedule(cfg), src, cond, 5,
                                  **draws)
    n_cap = len(capture.CAPTURES)
    counts, outs = [], []
    for _ in range(3):  # eager (the warm-up), captured + replayed, replayed
        before = dict(LAUNCH_COUNTS)
        outs.append(run())
        torch.cuda.synchronize()
        counts.append({k: v - before[k] for k, v in LAUNCH_COUNTS.items()})
        assert len(capture.CAPTURES) == n_cap + (len(outs) > 1)
    assert counts[0]["knn_pruned"] == 10 and counts[0]["grid_interp"] == 0
    assert counts[1] == counts[2] == counts[0]
    monkeypatch.setattr(samplers, "run_captured",
                        lambda key, body, inputs, owner, **kw: body(inputs))
    eager = run()
    assert all(torch.equal(o, eager) for o in outs)


def test_train_step_captured_matches_eager(cuda, tmp_path):
    """Two trainers from one seed at a small float32 size, one with its
    steps eager, one through the capture runner (first call eager, second
    captured, then replays), 6 mini-steps and 2 eval steps on the same
    batches: one capture a kind, the first mini-step's loss terms
    identical, every term within 1e-5, the emit pattern F, F, T, F, F, T,
    the same launches each call, the parameters within 2.2 lr (the
    backward's float atomics add in another order each run, and a
    rounding-noise gradient's sign moves its weight by about lr either
    way) and every state tensor at its address. After the first optimizer
    step the eager trainer's state is loaded into the captured one, in
    place: its graph must read it, and the second cycle starts alike."""
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import capture
    from pointcloud_style_transfer_torch.training import DiffusionTrainer
    cfg = Config(total_points=2048, global_points=512, feature_dim=32,
                 time_embed_dim=16, use_amp=False, batch_size=2,
                 checkpoint_dir=str(tmp_path / "c"),
                 log_dir=str(tmp_path / "l"), result_dir=str(tmp_path / "r"))
    eager, graphed = (DiffusionTrainer(cfg, resume=False, device=cuda)
                      for _ in range(2))
    eager._graphed = lambda draws: False
    keys = {k: graphed.step_key(k) for k in ("train", "eval")}
    gen = torch.Generator(device=cuda).manual_seed(3)
    batches = [(torch.randn((2, 2048, 3), generator=gen, device=cuda),
                torch.randn((2, 2048, 3), generator=gen, device=cuda) * 0.3)
               for _ in range(3)]
    n_cap = len(capture.CAPTURES)
    emits, lr = [], 1e-3
    for i in range(6):
        sim, real = batches[i % 3]
        if i == 3:  # a common start after the first optimizer step
            graphed.load_state(eager.state())
        outs, counts = [], []
        for t in (eager, graphed):
            before = dict(LAUNCH_COUNTS)
            terms, emit = t.train_step(sim, real, lr)
            torch.cuda.synchronize()
            counts.append({k: v - before[k] for k, v in LAUNCH_COUNTS.items()})
            outs.append(({k: float(v) for k, v in terms.items()}, bool(emit)))
        assert counts[0] == counts[1] and counts[0]["knn_topk"] == 2
        (te, ee), (tg, eg) = outs
        assert ee == eg
        emits.append(eg)
        if i == 0:
            assert te == tg
        for k in te:
            assert abs(tg[k] / te[k] - 1) <= 1e-5, (i, k)
        for k, p in graphed.params.items():
            assert (p - eager.params[k]).abs().max() <= 2.2 * lr, k
    assert emits == [False, False, True, False, False, True]
    for i in range(2):
        sim, real = batches[i]
        te, tg = eager.eval_step(sim, real), graphed.eval_step(sim, real)
        assert abs(float(tg["total_loss"]) / float(te["total_loss"]) - 1) \
            <= 1e-5
    assert len(capture.CAPTURES) == n_cap + 2
    assert {k: graphed.step_key(k) for k in keys} == keys


@pytest.fixture
def points_mesh(cuda):
    """A {points: 1} mesh on a one-rank NCCL group (started here when no
    group is), and its group; the group is ended after the test if this
    fixture started it."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.parallel import make_mesh
    from pointcloud_style_transfer_torch.parallel.mesh import axis_group
    started = not dist.is_initialized()
    mesh = make_mesh({"points": 1}, "cuda")
    yield mesh, axis_group(mesh, "points")
    if started:
        dist.destroy_process_group()


class _Owner:
    pass


def test_collectives_captured_match_eager(cuda, points_mesh):
    """Each collective of the meshed paths (``mesh.all_gather``,
    ``AllGather`` and ``AllReduceSum`` forward and backward, an all-reduce
    of a flat buffer) through ``run_captured(groups=)`` on a one-rank NCCL
    group: eager first, captured second, then replays on new inputs, each
    identical to the body run eagerly on the same inputs."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.models import capture
    from pointcloud_style_transfer_torch.parallel.mesh import (
        AllGather, AllReduceSum, all_gather)
    _, group = points_mesh
    gen = torch.Generator(device=cuda).manual_seed(4)

    def grad_of(fn):
        def body(ins):
            x = ins["x"].detach().requires_grad_()
            return torch.autograd.grad(fn(x), x, ins["g"])[0]
        return body

    def flat_sum(ins):
        flat = ins["x"].clone()
        dist.all_reduce(flat, group=group)
        return flat
    bodies = {
        "all_gather": (lambda ins: all_gather(ins["x"], group, 1), None),
        "AllGather": (lambda ins: AllGather.apply(ins["x"], group, 1), None),
        "AllGather grad": (grad_of(lambda x: AllGather.apply(x, group, 1)),
                           (1, 300, 3)),
        "AllReduceSum": (lambda ins: AllReduceSum.apply(ins["x"], group),
                         None),
        "AllReduceSum grad": (grad_of(lambda x: AllReduceSum.apply(x,
                                                                    group)),
                              (1, 300, 3)),
        "all_reduce": (flat_sum, None)}
    owner = _Owner()
    for name, (body, g_shape) in bodies.items():
        n_cap = len(capture.CAPTURES)
        for call in range(4):
            ins = {"x": torch.randn((1, 300, 3), generator=gen, device=cuda)}
            if g_shape:
                ins["g"] = torch.randn(g_shape, generator=gen, device=cuda)
            got = capture.run_captured(("collective", name), body, ins, owner,
                                       cache="parallel", groups=[group])
            assert torch.equal(got, body(ins)), (name, call)
            assert len(capture.CAPTURES) == n_cap + (call > 0), (name, call)


def test_sharded_sampler_captured_matches_eager(cuda, points_mesh,
                                                monkeypatch):
    """``guided_sample_loop(mesh=)`` on {points: 1} through the capture
    runner at a small size: its first call eager, its second captured and
    replayed, its third replayed, each identical to its eager body and to
    ``guided_sample_loop`` without a mesh (a key of its own)."""
    import functools
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, capture, guided_sample_loop, make_schedule,
        samplers)
    mesh, _ = points_mesh
    grid = dict(grid_shape=(2, 2, 2), tq=64, slot_cap=256)
    monkeypatch.setattr(grid_knn, "grid_knn_interpolate_layout",
                        functools.partial(
                            grid_knn.grid_knn_interpolate_layout, **grid))
    torch.manual_seed(0)
    cfg = Config(total_points=2048, global_points=512, feature_dim=32,
                 time_embed_dim=16, use_amp=False, knn_backend="grid")
    model = PointCloudDiffusionModel(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    src, cond, x0 = (torch.randn((1, 2048, 3), generator=gen, device=cuda)
                     for _ in range(3))
    draws = dict(x_init=x0, step_priorities=torch.rand(
        (5, 1, 2048), generator=gen, device=cuda),
        cond_priority=torch.rand((1, 2048), generator=gen, device=cuda),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64, device=cuda))

    def run(**kw):
        return guided_sample_loop(model, make_schedule(cfg), src, cond, 5,
                                  **draws, **kw)
    single = run()
    n_cap = len(capture.CAPTURES)
    outs = []
    for _ in range(3):  # eager (the warm-up), captured + replayed, replayed
        outs.append(run(mesh=mesh))
        assert len(capture.CAPTURES) == n_cap + (len(outs) > 1)
    monkeypatch.setattr(samplers, "run_captured",
                        lambda key, body, inputs, owner, **kw: body(inputs))
    eager = run(mesh=mesh)
    assert all(torch.equal(o, eager) for o in outs)
    assert torch.equal(eager, single)


# the denoiser's residual block (csrc/denoiser_block.cu)

BLOCK_ROWS = [1, 63, 64, 127, 128, 15_000, 60_000, 240_000]


def block_inputs(cuda, rows, perturbed, seed=0):
    """x [rows, 256] ~ N(0, 1) and fc1's and fc2's bf16 weights and biases
    from ``NoisePredictor``'s seeded init (zero biases), or that init with
    every weight and bias moved by 0.05 N(0, 1)."""
    from pointcloud_style_transfer_torch.models import NoisePredictor
    torch.manual_seed(seed)
    net = NoisePredictor(256, 128, compute_dtype=torch.bfloat16)
    fc1, fc2 = net.blocks[0]
    ws = [fc1.weight, fc1.bias, fc2.weight, fc2.bias]
    gen = torch.Generator().manual_seed(seed + 1)
    if perturbed:
        ws = [w + 0.05 * torch.randn(w.shape, generator=gen) for w in ws]
    x = torch.randn((rows, 256), generator=gen)
    return [t.detach().to(cuda, torch.bfloat16) for t in (x, *ws)]


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("rows", BLOCK_ROWS)
def test_denoiser_block_kernel_against_plain(cuda, rows, perturbed):
    """Against the block in float32 on the same bf16 inputs, the kernel's
    error is at most 1.1x the bf16 plain version's, by max and by median:
    both round at the same points, and only the products' summation order
    differs (a bf16 rounding of a pre-activation, rarely a ReLU sign at
    |pre-activation| under an ulp). One launch."""
    from pointcloud_style_transfer_torch.ops.kernels import (
        denoiser_block_cuda, denoiser_block_plain)
    ins = block_inputs(cuda, rows, perturbed)
    before = LAUNCH_COUNTS["denoiser_block"]
    got = denoiser_block_cuda(*ins)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["denoiser_block"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == ins[0].shape
    plain = denoiser_block_plain(*ins)
    exact = denoiser_block_plain(*(t.float() for t in ins))
    err_k = (got.float() - exact).abs()
    err_p = (plain.float() - exact).abs()
    assert torch.isfinite(got).all()
    assert err_k.max() <= 1.1 * err_p.max()
    assert err_k.median() <= 1.1 * err_p.median()


def test_denoiser_block_backward_and_counts(cuda):
    """The autograd op's gradients are the plain version's (its backward
    differentiates the plain block); ``NoisePredictor`` in eval mode, with
    or without grad, launches the kernel once a block, 6 a call, and its
    output stays within bf16 rounding of the layers' path."""
    from pointcloud_style_transfer_torch.models import NoisePredictor
    from pointcloud_style_transfer_torch.ops.kernels import (
        denoiser_block, denoiser_block_plain)
    ins = block_inputs(cuda, 3000, True)
    g = torch.randn(ins[0].shape, device=cuda).to(torch.bfloat16)
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    before = LAUNCH_COUNTS["denoiser_block"]
    out = denoiser_block(*a)
    assert LAUNCH_COUNTS["denoiser_block"] == before + 1
    for ga, gb in zip(torch.autograd.grad(out, a, g),
                      torch.autograd.grad(denoiser_block_plain(*b), b, g)):
        assert torch.equal(ga, gb)

    torch.manual_seed(0)
    net = NoisePredictor(256, 128, compute_dtype=torch.bfloat16).to(cuda)
    x = torch.randn((2, 5000, 3), device=cuda)
    t = torch.tensor([5, 500], device=cuda)
    style = torch.randn((2, 256), device=cuda)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            before = LAUNCH_COUNTS["denoiser_block"]
            got = net(x, t, style)
            assert LAUNCH_COUNTS["denoiser_block"] == before + 6
    with torch.no_grad():
        layers = net(x, t, style, selections={})  # the layers' path
    assert LAUNCH_COUNTS["denoiser_block"] == before + 6
    scale = layers.float().abs().max()
    assert (got.float() - layers.float()).abs().max() <= 0.05 * scale
    # a float32 model keeps the layers: no launch
    net32 = NoisePredictor(256, 128).to(cuda)
    with torch.no_grad():
        net32(x, t, style)
    assert LAUNCH_COUNTS["denoiser_block"] == before + 6


def test_denoiser_block_rejects_bad_inputs(cuda):
    """The kernel, and the wrapper for a CUDA tensor, raise for inputs the
    kernel does not compute (a float32 block among them): no fallback."""
    from pointcloud_style_transfer_torch.ops.kernels import (
        denoiser_block, denoiser_block_cuda)
    x, w1, b1, w2, b2 = block_inputs(cuda, 64, False)
    for bad in ([x.float(), w1, b1, w2, b2], [x[:, :128], w1, b1, w2, b2],
                [x, w1.t(), b1, w2, b2], [x, w1, b1[:256], w2, b2],
                [x.t().contiguous().t(), w1, b1, w2, b2]):
        with pytest.raises(ValueError):
            denoiser_block_cuda(*bad)
    with pytest.raises(ValueError):
        denoiser_block(*(t.float() for t in (x, w1, b1, w2, b2)))
