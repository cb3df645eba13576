"""Time every launch the kNN, FPS, kd-grid, ball query, row-min, packed-key
and pruned kNN kernels take, at the shapes their plans are chosen for, on
one CUDA card.

``knn_topk``: every cluster size S at the kd-grid's patch sizes (500 to
32,768 rows), the brute path's 90,000 rows and the Chamfer gradient's 30,000
rows, each x 30,000 refs, k = 3 and (30,000 rows) k = 1. ``fps``: every
(S, threads, PER) that holds the cloud, at 30,000 -> 512, 8,192 -> 512,
512 -> 128 and 65,536 -> 512, in us per iteration. ``grid_interp`` and
``grid_topk``: ``csrc/grid_fused.cu`` rebuilt for every staging chunk from
256 to 3,072 refs (``-DPCST_GRID_CHUNK``) on the slot tables of the grid's
own layout pass (90,000 queries, 30,000 refs, the sampler's grid), with
the layout's real-row counts, and the built-in chunk without them, in
device time (the profiler's: below ~0.08 ms the wrapper's host time, not
the kernel, paces back-to-back calls); the wrapper's host
time a call; the heaviest tile alone and the 132 heaviest (one an SM); and
(``[grid inserts]``) how often a warp of 32 queries passes the eight-ref
filter and runs an insert, counted with plain tensor ops for the runs in
slot order and in the kernel's staging order. ``ball_query``:
``csrc/ball_query.cu`` rebuilt for every (warps, steps a round)
(``-DPCST_BQ_WARPS``, ``-DPCST_BQ_UNROLL``) at the style encoder's two
calls, in device time. ``rowmin``: ``csrc/rowmin.cu`` rebuilt for every
cluster size S and number of queries a thread Q (``-DPCST_ROWMIN_S``,
``-DPCST_ROWMIN_Q``) at 120,000 x 120,000, 30,000 x 30,000 and
4,096 x 4,096, in device time. ``f32packed`` and ``packed``: the
f32-packed and the int-packed kernel launched with every cluster size S at
the sampler's 90,000 x 30,000 and the grid patch's 2,500 x 30,000, k = 3,
in device time. ``pruned``:
``csrc/knn_pruned.cu`` rebuilt for every cluster size S
(``-DPCST_PRUNED_S``), both passes of the pruned kNN at 90,000 x 30,000,
k = 3, default tiles, in device time, each also with the pass's own result
as its state (the scan alone), with the least, mean and largest count of
unskipped ref tiles a query tile in each pass.
Every launch's result is held identical to the plan's (the built-in
constants'), and the ball query's and row minimum's to their plain
versions. The clouds are ``chip_smoke.py``'s.

Run from the root of a checkout on a machine with the CUDA toolkit:
``python3 tools/sweep_kernel_plans.py [--only NAME,...]``, NAME among knn,
fps, grid, ball_query, rowmin, f32packed, packed, pruned (all by
default). It prints one line per shape and the card's name and power
limit. ``--parent DIR`` instead times the grid, ball query, row-min,
packed-key and pruned kernels of the checkout at DIR (an earlier commit, e.g. a ``git archive``
under ``build/``) against this checkout's, in turns (DIR, this, this, DIR),
each turn a fresh process that builds its own kernels: device time of each
kernel at the main path's shapes and calls (``[grid compare]``,
``[ball_query compare]``, ``[rowmin compare]``, ``[f32packed compare]``
with the int-packed kernel's ``[packed compare]``, ``[pruned compare]``;
``--only`` picks among them too).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, cuda_ms, device_ms, make_cloud  # noqa: E402
from pointcloud_style_transfer_torch.data import \
    normalize_point_cloud  # noqa: E402
from chip_smoke import GRID_SHAPE, GRID_TQ, SLOT_CAP  # noqa: E402
from pointcloud_style_transfer_torch.ops import (grid_knn,  # noqa: E402
                                                 index_points, pruned_knn)
from pointcloud_style_transfer_torch.ops.kernels import (  # noqa: E402
    ball_query_cuda, ball_query_plain, build_all, fps_cuda, grid_interp_cuda,
    grid_topk_cuda, knn_f32packed_keys_cuda, knn_intpacked_keys_cuda,
    knn_pruned_pass_cuda, knn_topk_cuda, rowmin_cuda, rowmin_plain)
from pointcloud_style_transfer_torch.ops.kernels.knn_packed import \
    padded_refs  # noqa: E402
from pointcloud_style_transfer_torch.ops.kernels import \
    _common  # noqa: E402
from pointcloud_style_transfer_torch.ops.kernels.fps import (  # noqa: E402
    CLUSTER_SIZES as FPS_CLUSTER_SIZES, PERS, fps_plan)
from pointcloud_style_transfer_torch.ops.kernels.knn import (  # noqa: E402
    CLUSTER_SIZES, knn_topk_plan)
from chip_smoke import (BQ_UNROLL, BQ_WARPS, PRUNED_S,  # noqa: E402
                        ROWMIN_Q, ROWMIN_S)

SWEEPS = ("knn", "fps", "grid", "ball_query", "rowmin", "f32packed",
          "packed", "pruned")
# the sweeps that --parent compares in turns
COMPARED = ("grid", "ball_query", "rowmin", "f32packed", "packed",
            "pruned")

ROWS = (500, 1825, 2500, 4096, 16384, 32768, 90000, 30000)


def sweep_knn(query: torch.Tensor, ref: torch.Tensor,
              rng: np.random.Generator) -> None:
    m = ref.shape[1]
    for rows in ROWS:
        q = query[:, torch.from_numpy(np.sort(rng.choice(
            query.shape[1], rows, replace=False))).to(ref.device)].contiguous()
        for k in ((3, 1) if rows == 30000 else (3,)):
            plan = knn_topk_plan(1, rows, m)
            d, i = knn_topk_cuda(q, ref, k)
            times = {}
            for S in CLUSTER_SIZES:
                d2, i2 = knn_topk_cuda(q, ref, k, plan=S)
                if not (torch.equal(i2, i) and torch.equal(d2, d)):
                    raise SystemExit(f"knn_topk {rows}x{m} S={S} differs")
                times[S] = cuda_ms(lambda: knn_topk_cuda(q, ref, k, plan=S),
                                   reps=20)
            best = min(times, key=times.get)
            print(f"[knn sweep] {rows}x{m} k={k}: plan S={plan}, fastest "
                  f"S={best}; ms by S: " + " ".join(
                      f"{S} {t:.4f}" for S, t in times.items()))


def sweep_fps(ref: torch.Tensor, big: torch.Tensor) -> None:
    start = torch.zeros(1, dtype=torch.int32, device=ref.device)
    small = index_points(ref, fps_cuda(ref, 512, start)).contiguous()
    for xyz, npoint in ((ref, 512), (ref[:, :8192].contiguous(), 512),
                        (small, 128), (big, 512)):
        n = xyz.shape[1]
        want = fps_cuda(xyz, npoint, start)
        times = {}
        for S in FPS_CLUSTER_SIZES:
            for threads in (32, 64, 128, 256, 512, 1024):
                per = next((p for p in PERS if threads * p >= -(-n // S)),
                           None)
                if per is None or (threads > 32 and threads // 2 >= -(-n // S)):
                    continue  # cannot hold the slice, or half the threads do
                plan = (S, threads, per)
                if not torch.equal(fps_cuda(xyz, npoint, start, plan=plan),
                                   want):
                    raise SystemExit(f"fps {n}->{npoint} plan {plan} differs")
                times[plan] = 1e3 * cuda_ms(lambda: fps_cuda(
                    xyz, npoint, start, plan=plan), reps=10) / npoint
        best = min(times, key=times.get)
        print(f"[fps sweep] {n}->{npoint}: plan {fps_plan(n)} "
              f"{times[fps_plan(n)]:.3f}, fastest {best} {times[best]:.3f} us "
              "per iteration; all (S/threads/PER): " + " ".join(
                  f"{S}/{t}/{p} {u:.3f}" for (S, t, p), u in times.items()))


# refs staged at a time: 16 bytes each in at most 48 KB of static shared
# memory; GRID_CHUNK is the source's own
GRID_CHUNKS = (256, 512, 768, 1024, 1536, 2048, 3072)
GRID_CHUNK = _common.source_define("grid_fused", "PCST_GRID_CHUNK")


def sweep_grid(query: torch.Tensor, ref: torch.Tensor,
               rng: np.random.Generator) -> None:
    vals = torch.from_numpy(rng.standard_normal(
        (ref.shape[1], 3)).astype(np.float32)).to(ref.device)
    struct = grid_knn._build_struct(ref[0], GRID_SHAPE, skip_z_sort=True)
    sl = grid_knn._layout_slots(struct, query[0], GRID_SHAPE, GRID_TQ,
                                SLOT_CAP)
    vals_pad = grid_knn._sorted_values(struct, vals)
    libs = _common.build_variants("grid_fused", {
        c: (f"-DPCST_GRID_CHUNK={c}",) for c in GRID_CHUNKS})
    for name, fn in (
            ("grid_interp", lambda **kw: grid_interp_cuda(
                sl.q_pad, struct.refs_pad, vals_pad, sl.st, sl.en, 3, **kw)),
            ("grid_topk", lambda **kw: grid_topk_cuda(
                sl.q_pad, struct.refs_pad, sl.st, sl.en, 3, **kw))):
        want = fn(n_real=sl.n_real)
        times = {}
        for chunk, lib in libs.items():
            with _common.launching("grid_fused", lib):
                got = fn(n_real=sl.n_real)
                if not all(torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
                           for g, w in zip(got, want)):
                    raise SystemExit(f"{name} chunk {chunk} differs")
                times[chunk] = device_ms(lambda: fn(n_real=sl.n_real),
                                         "grid_")
        without = device_ms(lambda: fn(), "grid_")
        best = min(times, key=times.get)
        print(f"[grid sweep] {name} {query.shape[1]}x{ref.shape[1]} k=3, "
              f"device ms: built-in chunk {GRID_CHUNK} "
              f"{times[GRID_CHUNK]:.4f}, fastest chunk {best} "
              f"{times[best]:.4f}, built-in without n_real {without:.4f}; by "
              "chunk: " + " ".join(f"{c} {t:.4f}" for c, t in times.items()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        grid_topk_cuda(sl.q_pad, struct.refs_pad, sl.st, sl.en, 3,
                       n_real=sl.n_real)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    # the heaviest tiles by real rows x candidates, alone
    T = sl.st.shape[0]
    work = sl.n_real.long() * (sl.en - sl.st).clamp(min=0).sum(1)
    heavy = {}
    for n in (1, 132):
        idx = torch.argsort(work, descending=True)[:n].sort().values
        q = sl.q_pad.view(T, GRID_TQ, 3)[idx].reshape(-1, 3).contiguous()
        st, en = sl.st[idx].contiguous(), sl.en[idx].contiguous()
        nr = sl.n_real[idx].contiguous()
        heavy[n] = device_ms(lambda: grid_topk_cuda(
            q, struct.refs_pad, st, en, 3, n_real=nr), "grid_")
    print(f"[grid sweep] grid_topk host time {host_us:.1f} us a call "
          f"(wrapper, no sync); device ms of the heaviest tile alone "
          f"{heavy[1]:.4f}, of the 132 heaviest (one an SM) {heavy[132]:.4f}")
    for order in ("slot", "staging"):
        g, passed, bodies = insert_counts(sl, struct.refs_pad, order)
        print(f"[grid inserts] k=3, runs in {order} order: {g} groups of "
              f"eight refs x warps of 32 real rows; the filter passes for "
              f"{100 * passed / g:.1f}% of them, {bodies / g:.2f} insert "
              "bodies a group (refs some query of the warp takes)")


BQ_PLANS = [(w, u) for w in (4, 8, 16, 32) for u in (1, 2, 4, 8)]


def encoder_calls(ref: torch.Tensor) -> list:
    """The style encoder's two ball queries on ``ref``'s FPS centers:
    (points, centers, radius, nsample) each."""
    start = torch.zeros(1, dtype=torch.int32, device=ref.device)
    c1 = index_points(ref, fps_cuda(ref, 512, start)).contiguous()
    c2 = index_points(c1, fps_cuda(c1, 128, start)).contiguous()
    return [(ref, c1, 0.2, 32), (c1, c2, 0.4, 64)]


def sweep_ball_query(ref: torch.Tensor) -> None:
    calls = encoder_calls(ref)
    libs = _common.build_variants("ball_query", {
        p: (f"-DPCST_BQ_WARPS={p[0]}", f"-DPCST_BQ_UNROLL={p[1]}")
        for p in BQ_PLANS})
    times = {}
    for plan, lib in libs.items():
        with _common.launching("ball_query", lib):
            for points, centers, radius, ns in calls:
                got = ball_query_cuda(radius, ns, points, centers)
                if not torch.equal(got, ball_query_plain(radius, ns, points,
                                                         centers)):
                    raise SystemExit(f"ball_query {plan} differs")
            times[plan] = [device_ms(lambda: ball_query_cuda(
                radius, ns, points, centers), "ball_query_kernel")
                for points, centers, radius, ns in calls]
    for i, (points, centers, radius, ns) in enumerate(calls):
        best = min(times, key=lambda p: times[p][i])
        built_in = times[(BQ_WARPS, BQ_UNROLL)][i]
        print(f"[ball_query sweep] {centers.shape[1]}x{points.shape[1]} "
              f"r={radius} ns={ns}, device ms: built-in "
              f"({BQ_WARPS}, {BQ_UNROLL}) {built_in:.5f}, fastest {best} "
              f"{times[best][i]:.5f}; by (warps, steps): " + " ".join(
                  f"{w}/{u} {t[i]:.5f}" for (w, u), t in times.items()))


ROWMIN_PLANS = [(S, Q) for S in (1, 2, 4, 8) for Q in (1, 2, 4, 8)]


def sweep_rowmin(rng: np.random.Generator, dev: torch.device) -> None:
    libs = _common.build_variants("rowmin", {
        p: (f"-DPCST_ROWMIN_S={p[0]}", f"-DPCST_ROWMIN_Q={p[1]}")
        for p in ROWMIN_PLANS})
    for n in (120000, 30000, 4096):
        q = torch.from_numpy(normalize_point_cloud(make_cloud(
            rng, n))[0])[None].to(dev)
        r = torch.from_numpy(normalize_point_cloud(make_cloud(
            rng, n))[0])[None].to(dev)
        q[0, 77, 1] = float("nan")
        want = rowmin_plain(q, r)
        nan = torch.isnan(want)
        times = {}
        for (S, Q), lib in libs.items():
            with _common.launching("rowmin", lib):
                got = rowmin_cuda(q, r)
                if not (torch.equal(torch.isnan(got), nan)
                        and torch.equal(got[~nan], want[~nan])):
                    raise SystemExit(f"rowmin {n}x{n} S={S} Q={Q} differs")
                times[(S, Q)] = device_ms(lambda: rowmin_cuda(q, r),
                                          "rowmin", reps=10)
        built_in = (ROWMIN_S, ROWMIN_Q)
        best = min(times, key=times.get)
        print(f"[rowmin sweep] {n}x{n}, device ms: built-in (S, Q) "
              f"{built_in} {times[built_in]:.4f}, fastest {best} "
              f"{times[best]:.4f}; by S/Q: " + " ".join(
                  f"{S}/{Q} {t:.4f}" for (S, Q), t in times.items()))


# sweep name: (kernel, its TPU wrapper's ref tile at 90,000 rows, at the
# patch)
PACKED = {"f32packed": (knn_f32packed_keys_cuda, 4096, 2048),
          "packed": (knn_intpacked_keys_cuda, 2048, 2048)}


def sweep_packed(name: str, query: torch.Tensor, ref: torch.Tensor) -> None:
    kernel, tr_rows, tr_patch = PACKED[name]
    m = ref.shape[1]
    for rows, tr in ((query.shape[1], tr_rows), (2500, tr_patch)):
        q = query[:, :rows].contiguous()
        m_total = padded_refs(m, tr)
        plan = knn_topk_plan(1, rows, m)
        want = kernel(q, ref, 3, m_total).view(torch.int32)
        times = {}
        for S in CLUSTER_SIZES:
            got = kernel(q, ref, 3, m_total, plan=S)
            if not torch.equal(got.view(torch.int32), want):
                raise SystemExit(f"knn_{name} {rows}x{m} S={S} differs")
            times[S] = device_ms(lambda: kernel(q, ref, 3, m_total, plan=S),
                                 f"knn_{name}_kernel")
        best = min(times, key=times.get)
        print(f"[{name} sweep] {rows}x{m} k=3 (padded to {m_total}), "
              f"device ms: plan S={plan} {times[plan]:.4f}, fastest S={best} "
              f"{times[best]:.4f}; by S: " + " ".join(
                  f"{S} {t:.4f}" for S, t in times.items()))


PRUNED_SIZES = (1, 2, 4, 8)


def pruned_passes(query: torch.Tensor, ref: torch.Tensor, k: int = 3,
                  tq: int = 512, tr: int = 2048) -> tuple:
    """The pruned kNN's two pass launches on one cloud, as
    ``ops/pruned_knn.py`` makes them: (qs, rs, [(skip, d_init, i_init) of
    each pass])."""
    qs, rs, _, _ = pruned_knn.sort_and_pad(query, ref, tq, tr)
    nq, nr = qs.shape[0] // tq, rs.shape[0] // tr
    in_window = pruned_knn.window_mask(nq, nr, 2, qs.device)
    skip1 = (~in_window).int().contiguous()
    d0 = qs.new_full((qs.shape[0], k), 1e30)
    i0 = torch.zeros((qs.shape[0], k), dtype=torch.int32, device=qs.device)
    d1, i1 = knn_pruned_pass_cuda(qs, rs, skip1, d0, i0, k, tq, tr)
    skip2 = (pruned_knn.prune_mask(qs, rs, d1, k, tq, tr)
             | in_window).int().contiguous()
    return qs, rs, [(skip1, d0, i0), (skip2, d1, i1)]


def sweep_pruned(query: torch.Tensor, ref: torch.Tensor) -> None:
    """Every cluster size S, each also with the pass's own result as its
    state, so that only the refs it keeps pass the eight-ref filter and the
    box test lets go all it can: the scan alone."""
    libs = _common.build_variants("knn_pruned", {
        S: (f"-DPCST_PRUNED_S={S}",) for S in PRUNED_SIZES})
    qs, rs, passes = pruned_passes(query[0], ref[0])
    for p, (skip, d_i, i_i) in enumerate(passes, 1):
        want = knn_pruned_pass_cuda(qs, rs, skip, d_i, i_i, 3, 512, 2048)
        n = (skip == 0).sum(1)
        times, alone = {}, {}
        for S, lib in libs.items():
            with _common.launching("knn_pruned", lib):
                got = knn_pruned_pass_cuda(qs, rs, skip, d_i, i_i, 3, 512,
                                           2048)
                if not all(torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
                           for g, w in zip(got, want)):
                    raise SystemExit(f"knn_pruned pass {p} S={S} differs")
                times[S] = device_ms(lambda: knn_pruned_pass_cuda(
                    qs, rs, skip, d_i, i_i, 3, 512, 2048),
                    "knn_pruned_pass_kernel")
                alone[S] = device_ms(lambda: knn_pruned_pass_cuda(
                    qs, rs, skip, *want, 3, 512, 2048),
                    "knn_pruned_pass_kernel")
        best = min(times, key=times.get)
        print(f"[pruned sweep] pass {p} {query.shape[1]}x{ref.shape[1]} k=3, "
              f"tiles 512x2048: unskipped tiles a query tile (least/mean/"
              f"largest) {int(n.min())}/{float(n.float().mean()):.2f}/"
              f"{int(n.max())}, {int(n.sum())} in all; device ms: built-in "
              f"S={PRUNED_S} {times[PRUNED_S]:.4f}, fastest S={best} "
              f"{times[best]:.4f}; by S: " + " ".join(
                  f"{S} {t:.4f}" for S, t in times.items())
              + "; the scan alone: " + " ".join(
                  f"{S} {t:.4f}" for S, t in alone.items()))


def staging_order(st: list, en: list, m: int) -> list:
    """A tile's candidates in ``csrc/grid_fused.cu``'s staging order."""
    runs = [(max(a, 0), max(min(b, m) - max(a, 0), 0)) for a, b in zip(st, en)]
    mid = len(runs) // 2
    lo, n = runs[mid]
    a, b = n // 3, 2 * n // 3
    pieces = [(lo + a, b - a), (lo, a), (lo + b, n - b)] + [
        r for s, r in enumerate(runs) if s != mid]
    return [p for lo, n in pieces for p in range(lo, lo + n)]


def insert_counts(sl, refs: torch.Tensor, order: str, k: int = 3
                  ) -> tuple[int, int, int]:
    """The kernel's scan, counted for all tiles at once with tensor ops:
    for every group of eight candidates and warp of 32 rows holding a real
    row, whether some real query's minimum of the eight is <= its k-th
    distance (the filter passes) and how many of the eight some real query
    takes (insert bodies the warp runs). Ties are ignored."""
    keep = sl.n_real > 0
    st, en = sl.st[keep].tolist(), sl.en[keep].tolist()
    m = refs.shape[0]
    lists = [staging_order(a, b, m) if order == "staging" else
             [p for x, y in zip(a, b) for p in range(max(x, 0), min(y, m))]
             for a, b in zip(st, en)]
    W = max(len(c) for c in lists)
    pos = torch.full((len(lists), W), -1, dtype=torch.long)
    for t, c in enumerate(lists):
        pos[t, :len(c)] = torch.tensor(c, dtype=torch.long)
    pos = pos.to(refs.device)
    q = sl.q_pad.view(-1, GRID_TQ, 3)[keep]
    real = (torch.arange(GRID_TQ, device=refs.device)[None, :]
            < sl.n_real[keep][:, None])
    warps = real.view(len(lists), -1, 32).any(2)
    D = torch.full((len(lists), GRID_TQ, k), 1e30, device=refs.device)
    groups = passed = bodies = 0
    for j0 in range(0, W - 7, 8):
        P = pos[:, j0:j0 + 8]
        d = ((q[:, :, None, :] - refs[P.clamp(min=0)][:, None]) ** 2).sum(-1)
        d = torch.where((P >= 0)[:, None, :], d, float("inf"))
        live = warps & (P[:, 7:8] >= 0)
        lane = (d.min(2).values <= D[:, :, -1]) & real
        groups += int(live.sum())
        passed += int((lane.view(len(lists), -1, 32).any(2) & live).sum())
        for u in range(8):
            take = (d[:, :, u] < D[:, :, -1]) & real
            bodies += int((take.view(len(lists), -1, 32).any(2) & live).sum())
            both = torch.cat([D, d[:, :, u:u + 1]], 2).sort(2).values
            D = torch.where(take[..., None], both[..., :k], D)
    return groups, passed, bodies


# One turn of --parent, run as ``python3 -c TURN ROOT`` so that it imports
# ROOT's package and builds ROOT's kernels; it uses only what every version
# of these kernels has, plus the real-row counts where the layout has them
# (the main path's call in that version), and each wrapper's own plan.
TURN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from chip_smoke import make_cloud, GRID_SHAPE, GRID_TQ, SLOT_CAP
from pointcloud_style_transfer_torch.data import normalize_point_cloud
from pointcloud_style_transfer_torch.ops import (grid_knn, index_points,
                                                 pruned_knn)
from pointcloud_style_transfer_torch.ops.kernels import (
    ball_query_cuda, fps_cuda, grid_interp_cuda, grid_topk_cuda,
    knn_f32packed_keys_cuda, knn_intpacked_keys_cuda, knn_pruned_pass_cuda,
    rowmin_cuda)
rng = np.random.default_rng(0)
dev = torch.device("cuda")
ref = torch.from_numpy(normalize_point_cloud(make_cloud(rng, 30000))[0])
query = torch.from_numpy(normalize_point_cloud(make_cloud(rng, 90000))[0])
ref, query = ref.to(dev), query.to(dev)
def device_ms(fn, name, reps=50):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in ev)  # the trace may drop a launch
    assert reps // 2 <= count <= reps, count
    return sum(e.self_device_time_total for e in ev) / 1e3 / count
out = {}
if "grid" in sys.argv[2]:
    vals = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (30000, 3)).astype(np.float32)).to(dev)
    s = grid_knn._build_struct(ref, GRID_SHAPE, skip_z_sort=True)
    sl = grid_knn._layout_slots(s, query, GRID_SHAPE, GRID_TQ, SLOT_CAP)
    vp = grid_knn._sorted_values(s, vals)
    kw = {"n_real": sl.n_real} if hasattr(sl, "n_real") else {}
    out["grid_interp"] = device_ms(lambda: grid_interp_cuda(
        sl.q_pad, s.refs_pad, vp, sl.st, sl.en, 3, **kw), "grid_")
    out["grid_topk"] = device_ms(lambda: grid_topk_cuda(
        sl.q_pad, s.refs_pad, sl.st, sl.en, 3, **kw), "grid_")
if "ball_query" in sys.argv[2]:
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    r3 = ref[None]
    c1 = index_points(r3, fps_cuda(r3, 512, start)).contiguous()
    c2 = index_points(c1, fps_cuda(c1, 128, start)).contiguous()
    out["ball_query 512x30000"] = device_ms(
        lambda: ball_query_cuda(0.2, 32, r3, c1), "ball_query_kernel")
    out["ball_query 128x512"] = device_ms(
        lambda: ball_query_cuda(0.4, 64, c1, c2), "ball_query_kernel")
if "packed" in sys.argv[2]:  # f32packed or packed: both kernels
    q3, r3 = query[None], ref[None]
    p3 = query[None, :2500].contiguous()
    out["knn_f32packed 90000x30000"] = device_ms(
        lambda: knn_f32packed_keys_cuda(q3, r3, 3, 32768), "packed_kernel")
    out["knn_f32packed 2500x30000"] = device_ms(
        lambda: knn_f32packed_keys_cuda(p3, r3, 3, 30720), "packed_kernel")
    out["knn_packed 90000x30000"] = device_ms(
        lambda: knn_intpacked_keys_cuda(q3, r3, 3, 30720), "packed_kernel")
    out["knn_packed 2500x30000"] = device_ms(
        lambda: knn_intpacked_keys_cuda(p3, r3, 3, 30720), "packed_kernel")
if "pruned" in sys.argv[2]:
    qs, rs, _, _ = pruned_knn.sort_and_pad(query, ref, 512, 2048)
    nq, nr = qs.shape[0] // 512, rs.shape[0] // 2048
    w = pruned_knn.window_mask(nq, nr, 2, dev)
    s1 = (~w).int().contiguous()
    d0 = qs.new_full((qs.shape[0], 3), 1e30)
    i0 = torch.zeros((qs.shape[0], 3), dtype=torch.int32, device=dev)
    d1, i1 = knn_pruned_pass_cuda(qs, rs, s1, d0, i0, 3, 512, 2048)
    s2 = (pruned_knn.prune_mask(qs, rs, d1, 3, 512, 2048)
          | w).int().contiguous()
    for p, (s, di, ii) in enumerate(((s1, d0, i0), (s2, d1, i1)), 1):
        out[f"knn_pruned pass {p} 90000x30000"] = device_ms(
            lambda: knn_pruned_pass_cuda(qs, rs, s, di, ii, 3, 512, 2048),
            "knn_pruned")
if "rowmin" in sys.argv[2]:
    for n in (120000, 30000):
        a = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])
        b = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])
        a, b = a[None].to(dev), b[None].to(dev)
        out[f"rowmin {n}x{n}"] = device_ms(lambda: rowmin_cuda(a, b),
                                           "rowmin", reps=10)
print(json.dumps(out))
"""


def compare(parent: Path, names: list) -> None:
    here = Path(__file__).resolve().parents[1]
    runs = []
    for root in (parent, here, here, parent):
        out = subprocess.run([sys.executable, "-c", TURN, str(root),
                              ",".join(names)],
                             cwd=root, capture_output=True, text=True,
                             check=True, timeout=900)
        runs.append((root == parent, json.loads(out.stdout.splitlines()[-1])))
    tags = {"grid_interp": "grid", "grid_topk": "grid",
            "ball_query": "ball_query", "rowmin": "rowmin",
            "knn_f32packed": "f32packed", "knn_packed": "packed",
            "knn_pruned": "pruned"}
    for key in runs[0][1]:
        tag = tags[key.split()[0]]
        print(f"[{tag} compare] {key}, device ms in turns (parent, change, "
              "change, parent): " + ", ".join(
                  f"{'parent' if p else 'change'} {r[key]:.5f}"
                  for p, r in runs))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    names = list(SWEEPS)
    if "--only" in sys.argv:
        names = sys.argv[sys.argv.index("--only") + 1].split(",")
        if not set(names) <= set(SWEEPS):
            raise SystemExit(f"--only takes names among {SWEEPS}")
    if "--parent" in sys.argv:
        compare(Path(sys.argv[sys.argv.index("--parent") + 1]).resolve(),
                [n for n in names if n in COMPARED])
        print(card_line())
        return 0
    build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(normalize_point_cloud(make_cloud(
        rng, 30000))[0])[None].to(dev)
    query = torch.from_numpy(normalize_point_cloud(make_cloud(
        rng, 90000))[0])[None].to(dev)
    big = torch.from_numpy(normalize_point_cloud(make_cloud(
        rng, 65536))[0])[None].to(dev)
    if "knn" in names:
        sweep_knn(query, ref, rng)
    if "fps" in names:
        sweep_fps(ref, big)
    if "grid" in names:
        sweep_grid(query, ref, np.random.default_rng(8))
    if "ball_query" in names:
        sweep_ball_query(ref)
    if "rowmin" in names:
        sweep_rowmin(np.random.default_rng(9), dev)
    for name in PACKED:
        if name in names:
            sweep_packed(name, query, ref)
    if "pruned" in names:
        sweep_pruned(query, ref)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
