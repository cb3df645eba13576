#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pointcloud_style_transfer_torch``) on one
NVIDIA GPU. Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases, each printing one line per result:

1. build — compile every CUDA kernel from ``csrc/`` (one nvcc per source, in
   parallel); the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes (numpy-seeded inputs with exact duplicate points,
   to force ties): identical indices, kNN distances within 1e-6 relative;
   the kd-grid's slot-run kernels on slot tables from the grid's own layout
   pass (90,000 queries, 30,000 refs): distances and positions identical,
   values within rtol 1e-6, atol 1e-6 * max|v|; the grid's interpolation
   after its fallback against the brute-force interpolation, and
   ``knn(backend="grid")`` (its own path, launch counts read around it)
   against the brute-force kNN; kernel, plain, library and bound times.
3. reference — clouds through the sampler on the card (kernels) and on the
   CPU (plain versions) with the same draws, float32, Chamfer-L2 <= 1e-3
   between the two: 4,096 points with the brute-force kNN, and 24,576 points
   with ``knn_backend="auto"``, where 6,144 coarse points engage the grid.
4. main path — a seeded full-width checkpoint (``Config()`` defaults, bf16,
   ``knn_backend="auto"``: the kd-grid), 120,000-point source and condition
   clouds, 50 steps at guidance 7.5 through the inference CLI's ``main``:
   output shape and finiteness, launch counts (50 grid interpolations, one
   brute-force patch for each step with unsafe rows, 2 FPS, 2 ball query
   per cloud), the per-step unsafe counts, seconds per cloud for the grid
   and for the brute-force kNN (``knn_backend="pallas"``), and a profiler
   breakdown of one grid cloud.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` name and
power-limit line, and the final JSON line. Without a card (or without the
package beside it) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pointcloud_style_transfer_torch.cli.inference import (DiffusionInference,
                                                           main as cli_main)
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.data import normalize_point_cloud
from pointcloud_style_transfer_torch.models import (DiffusionNet,
                                                    PointCloudDiffusionModel,
                                                    guided_sample_loop,
                                                    make_schedule)
from pointcloud_style_transfer_torch.ops import grid_knn, index_points, knn
from pointcloud_style_transfer_torch.ops.kernels import (
    LAUNCH_COUNTS, ball_query_cuda, ball_query_plain, build_all, fps_cuda,
    fps_plain, grid_interp_cuda, grid_interp_plain, grid_topk_cuda,
    grid_topk_plain, knn_topk_cuda, knn_topk_plain, reset_launch_counts)
from pointcloud_style_transfer_torch.ops.kernels._common import (
    BUILD_ROOT, library_path, pairwise_sq_dist)
from pointcloud_style_transfer_torch.ops.kernels.ball_query import \
    radius_sq_f32
from pointcloud_style_transfer_torch.utils.checkpoint import (
    save_checkpoint, split_state_dict)

# H100 SXM published peaks (dense): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_POINTS, M_POINTS = 120_000, 30_000
STEPS, GUIDANCE = 50, 7.5
# the grid's defaults, which the sampler uses
GRID_SHAPE, GRID_TQ, SLOT_CAP = (16, 12, 8), 128, 384


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_cloud(rng: np.random.Generator, n: int, dup_frac: float = 0.01,
               scale: float = 30.0) -> np.ndarray:
    """A LiDAR-like scene (ground plane + object clusters) in metres, with a
    fraction of exact duplicate points to force distance ties."""
    n_ground = n // 2
    ground = np.c_[rng.uniform(-scale, scale, (n_ground, 2)),
                   rng.normal(0.0, 0.05, n_ground)]
    centers = np.c_[rng.uniform(-scale, scale, (40, 2)),
                    rng.uniform(0.5, 3.0, 40)]
    which = rng.integers(0, 40, n - n_ground)
    objects = centers[which] + rng.normal(0.0, 0.8, (n - n_ground, 3))
    pts = np.concatenate([ground, objects]).astype(np.float32)
    pts = pts[rng.permutation(n)]
    n_dup = int(n * dup_frac)
    pts[rng.choice(n, n_dup, replace=False)] = pts[rng.choice(n, n_dup)]
    return pts


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build_all()
    dt = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernels built in {dt:.1f}s into {BUILD_ROOT}")
    for name in paths:
        log = library_path(name).with_suffix(".log").read_text()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name} ptxas: " + " | ".join(usage))
    print(f"[build] card: {card_line()}")


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor,
                what: str = "indices") -> None:
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        fail(f"{name}: {bad} of {want.numel()} {what} differ from the plain "
             "version")


def values_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want|; fails beyond rtol 1e-6, atol 1e-6 * max|want|."""
    err = (got - want).abs()
    tol = 1e-6 * want.abs().max() + 1e-6 * want.abs()
    if not (err <= tol).all():
        return float("inf")
    return err.max().item()


def phase_kernels(rng: np.random.Generator, dev: torch.device) -> dict:
    """Kernels vs plain versions at the main path's shapes; returns the
    per-kernel records (launches filled in later)."""
    records = {}
    cloud = normalize_point_cloud(make_cloud(rng, M_POINTS))[0]
    other = normalize_point_cloud(make_cloud(rng, N_POINTS - M_POINTS))[0]
    # a few queries sit exactly on (possibly duplicated) refs: zero-distance ties
    other[:500] = cloud[rng.choice(M_POINTS, 500)]
    ref = torch.from_numpy(cloud)[None].to(dev)
    query = torch.from_numpy(other)[None].to(dev)

    # -- kNN, k=3, 90,000 x 30,000 --
    d_k, i_k = knn_topk_cuda(query, ref, 3)
    d_p, i_p = knn_topk_plain(query, ref, 3)
    torch.cuda.synchronize()
    check_equal("knn_topk", i_k, i_p)
    rel = ((d_k - d_p).abs() / d_p.abs().clamp(min=1e-30)).max().item()
    if rel > 1e-6:
        fail(f"knn_topk: distances differ by {rel:.3g} relative (> 1e-6)")
    max_err = (d_k - d_p).abs().max().item()
    ms = cuda_ms(lambda: knn_topk_cuda(query, ref, 3), reps=20)
    plain_ms = cuda_ms(lambda: knn_topk_plain(query, ref, 3), reps=2)

    def library():
        q, r = query[0], ref[0]
        for s in range(0, q.shape[0], 8192):
            torch.topk(torch.cdist(q[s:s + 8192], r), 3, largest=False)
    lib_ms = cuda_ms(library, reps=3)
    nq, m = query.shape[1], ref.shape[1]
    b_ms, b_by = bound_ms((nq + m) * 12 + nq * 3 * 8, 8.0 * nq * m)
    records["knn_topk"] = dict(
        name="knn_topk", route="cuda",
        source="pointcloud_style_transfer_torch/csrc/knn_topk.cu",
        replaces="pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py:40",
        shape=f"{nq}x{m} k=3", max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    print(f"[kernels] knn_topk {nq}x{m} k=3: indices identical, max rel "
          f"d err {rel:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"library (cdist+topk) {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")

    # -- FPS 30,000 -> 512 and 512 -> 128 --
    fps_rows = []
    xyz = ref
    for npoint in (512, 128):
        start = torch.tensor([int(rng.integers(xyz.shape[1]))],
                             dtype=torch.int32, device=dev)
        got = fps_cuda(xyz, npoint, start)
        want = fps_plain(xyz, npoint, start)
        torch.cuda.synchronize()
        check_equal(f"fps {xyz.shape[1]}->{npoint}", got, want)
        n = xyz.shape[1]
        ms = cuda_ms(lambda: fps_cuda(xyz, npoint, start), reps=20)
        plain_ms = cuda_ms(lambda: fps_plain(xyz, npoint, start), reps=2)
        b_ms, b_by = bound_ms(n * 12 + 4 + npoint * 4, 9.0 * npoint * n)
        fps_rows.append((xyz, got))
        print(f"[kernels] fps {n}->{npoint}: indices identical; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
              f"({b_by}; latency-bound by {npoint} dependent argmaxes)")
        if npoint == 512:
            records["fps"] = dict(
                name="fps", route="cuda",
                source="pointcloud_style_transfer_torch/csrc/fps.cu",
                replaces="pointcloud_style_transfer_tpu/ops/pallas/fps.py:31",
                shape=f"{n}->{npoint}", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
        xyz = index_points(xyz, got).contiguous()

    # -- ball query at the encoder's two calls --
    for (points, sel), radius, ns in zip(fps_rows, (0.2, 0.4), (32, 64)):
        centers = index_points(points, sel).contiguous()
        got = ball_query_cuda(radius, ns, points, centers)
        want = ball_query_plain(radius, ns, points, centers)
        torch.cuda.synchronize()
        s, n = centers.shape[1], points.shape[1]
        check_equal(f"ball_query {s}x{n}", got, want)
        # the work this data needs: each center's scan ends at its ns-th hit
        inside = pairwise_sq_dist(centers[0], points[0]) <= radius_sq_f32(radius)
        hits = torch.cumsum(inside.int(), dim=1)
        full = hits[:, -1] >= ns
        scan = torch.where(full, torch.argmax((hits >= ns).int(), dim=1) + 1, n)
        pairs = scan.sum().item()
        empty = (~inside.any(dim=1)).sum().item()
        ms = cuda_ms(lambda: ball_query_cuda(radius, ns, points, centers),
                     reps=50)
        plain_ms = cuda_ms(lambda: ball_query_plain(radius, ns, points,
                                                    centers), reps=3)
        b_ms, b_by = bound_ms((s + n) * 12 + s * ns * 4, 9.0 * pairs)
        print(f"[kernels] ball_query {s}x{n} r={radius} ns={ns}: indices "
              f"identical ({int(full.sum())} rows full, {empty} empty, "
              f"{pairs} pairs scanned); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
        if ns == 32:
            records["ball_query"] = dict(
                name="ball_query", route="cuda",
                source="pointcloud_style_transfer_torch/csrc/ball_query.cu",
                replaces="pointcloud_style_transfer_tpu/ops/pallas/"
                         "distance_topk.py:371",
                shape=f"{s}x{n} r={radius} ns={ns}", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
    records.update(phase_grid_kernels(rng, query, ref))
    return records


def phase_grid_kernels(rng: np.random.Generator, query: torch.Tensor,
                       ref: torch.Tensor) -> dict:
    """The grid's slot-run kernels on the tables of its own layout pass,
    its interpolation after the fallback against brute force, and the
    ``knn(backend="grid")`` path."""
    records = {}
    nq, m = query.shape[1], ref.shape[1]
    vals = torch.from_numpy(
        rng.standard_normal((m, 3)).astype(np.float32)).to(ref.device)
    fz = grid_knn._full_z_ok(m, GRID_SHAPE, SLOT_CAP)
    struct = grid_knn._build_struct(ref[0], GRID_SHAPE, skip_z_sort=fz)
    sl = grid_knn._layout_slots(struct, query[0], GRID_SHAPE, GRID_TQ,
                                SLOT_CAP)
    q_pad, refs_pad, st, en = sl.q_pad, struct.refs_pad, sl.st, sl.en
    vals_pad = grid_knn._sorted_values(struct, vals)
    T, S = st.shape
    runs = (en - st).clamp(min=0).sum(1)  # candidates per tile
    # the pairs this data needs: each real query against its tile's runs
    # (the kernel also scans for the layout's padding queries)
    pairs = int((sl.real.sum(1) * runs).sum())
    shape = (f"{nq} queries in {T} tiles of {GRID_TQ}, {S} slots, "
             f"{m} refs, k=3")
    print(f"[kernels] grid tables {GRID_SHAPE}/{SLOT_CAP}: {shape}; "
          f"candidates per tile mean {runs.float().mean():.1f}, max "
          f"{int(runs.max())}; {pairs} pairs for real queries, "
          f"{GRID_TQ * int(runs.sum())} scanned with padding (brute force: "
          f"{nq * m})")

    v_k, d_k = grid_interp_cuda(q_pad, refs_pad, vals_pad, st, en, 3)
    v_p, d_p = grid_interp_plain(q_pad, refs_pad, vals_pad, st, en, 3)
    d_t, i_t = grid_topk_cuda(q_pad, refs_pad, st, en, 3)
    d_tp, i_tp = grid_topk_plain(q_pad, refs_pad, st, en, 3)
    torch.cuda.synchronize()
    full = d_p[:, -1] < 1e29
    check_equal("grid_interp", d_k[full], d_p[full], "distances")
    check_equal("grid_topk", d_t[full], d_tp[full], "distances")
    check_equal("grid_topk", i_t[full], i_tp[full], "positions")
    v_err = values_err(v_k[full], v_p[full])
    if not np.isfinite(v_err) or not torch.isfinite(v_k).all():
        fail("grid_interp: values differ from the plain version beyond "
             "rtol 1e-6, atol 1e-6 * max|v| (or are not finite)")
    in_bytes = (q_pad.numel() + refs_pad.numel() + st.numel() + en.numel()) * 4
    for name, fn, plain, out_bytes, err in (
            ("grid_interp",
             lambda: grid_interp_cuda(q_pad, refs_pad, vals_pad, st, en, 3),
             lambda: grid_interp_plain(q_pad, refs_pad, vals_pad, st, en, 3),
             vals_pad.numel() * 4 + (v_k.numel() + d_k.numel()) * 4, v_err),
            ("grid_topk", lambda: grid_topk_cuda(q_pad, refs_pad, st, en, 3),
             lambda: grid_topk_plain(q_pad, refs_pad, st, en, 3),
             (d_t.numel() + i_t.numel()) * 4, 0.0)):
        ms = cuda_ms(fn, reps=20)
        plain_ms = cuda_ms(plain, reps=2)
        b_ms, b_by = bound_ms(in_bytes + out_bytes, 8.0 * pairs)
        records[name] = dict(
            name=name, route="cuda",
            source="pointcloud_style_transfer_torch/csrc/grid_fused.cu",
            replaces="pointcloud_style_transfer_tpu/ops/pallas/grid_fused.py:"
                     + ("127" if name == "grid_interp" else "53"),
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"[kernels] {name}: {int(full.sum())} of {len(full)} rows with "
              f"3 candidates, distances and positions identical, max |v| err "
              f"{err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}, {pairs} pairs); library: none "
              "(no PyTorch call computes a kNN over slot runs)")

    # the grid's interpolation after its fallback vs brute interpolation
    grid_knn.UNSAFE_COUNTS.clear()
    v_lay, qid = grid_knn.grid_knn_interpolate_layout(query[0], ref[0], vals)
    n_unsafe = grid_knn.UNSAFE_COUNTS[-1]
    real = qid < nq
    v_grid = torch.empty_like(v_lay[:nq])
    v_grid[qid[real].long()] = v_lay[real]
    v_brute = grid_knn._brute_interp(query[0], ref[0], vals, 3, 1e-8)
    d4, _ = knn_topk_cuda(query, ref, 4)
    tie = d4[0, :, 2] == d4[0, :, 3]  # the 3rd and 4th nearest tie exactly
    err = values_err(v_grid[~tie], v_brute[~tie])
    if not np.isfinite(err):
        fail("grid_knn_interpolate_layout differs from the brute-force "
             "interpolation beyond rtol 1e-6, atol 1e-6 * max|v|")
    layout_ms = cuda_ms(lambda: grid_knn.grid_knn_interpolate_layout(
        query[0], ref[0], vals), reps=10)
    patch = query[:, :2500].contiguous()
    patch_ms = cuda_ms(lambda: knn_topk_cuda(patch, ref, 3), reps=20)
    print(f"[kernels] grid_knn_interpolate_layout {nq}x{m}: {n_unsafe} unsafe "
          f"rows patched by brute force; vs brute interpolation max |v| err "
          f"{err:.3g} on the {int((~tie).sum())} rows whose 3rd/4th nearest "
          f"do not tie ({int(tie.sum())} tie exactly); whole call "
          f"{layout_ms:.4f} ms (layout, tables, kernel, margins, patch); "
          f"knn_topk on a 2500-query patch {patch_ms:.4f} ms")

    grid_breakdown(query[0], ref[0], vals)

    # knn(backend="grid"): its own path, counts read around it
    reset_launch_counts()
    d_g, i_g = knn(query, ref, 3, backend="grid")
    torch.cuda.synchronize()
    path_counts = dict(LAUNCH_COUNTS)
    records["grid_topk"]["launches"] = path_counts["grid_topk"]
    records["grid_topk"]["path"] = "knn(backend='grid')"
    if path_counts["grid_topk"] != 1:
        fail(f"knn(backend='grid') launched grid_topk "
             f"{path_counts['grid_topk']} times")
    d_b, i_b = knn_topk_cuda(query, ref, 3)
    check_equal("knn(backend='grid') vs knn_topk", d_g, d_b, "distances")
    differ = i_g != i_b
    alt = ref[0][i_g[0].long()] - query[0][:, None]  # the grid's choices
    d_alt = (alt[..., 0] * alt[..., 0] + alt[..., 1] * alt[..., 1]
             ) + alt[..., 2] * alt[..., 2]
    if not torch.equal(d_alt, d_b[0]):
        fail("knn(backend='grid') chose refs whose distances are not the "
             "brute-force ones")
    print(f"[kernels] knn(backend='grid') {nq}x{m} k=3: launches "
          f"{path_counts}; distances identical to knn_topk, {int(differ.sum())}"
          f" ids differ, each an exactly equidistant ref")
    return records

def grid_breakdown(q: torch.Tensor, r: torch.Tensor,
                   vals: torch.Tensor) -> None:
    """Where one grid interpolation call's time goes: each phase run on its
    own between two synchronisations (host clock, best of 5), then one
    whole call under the profiler; beside it the brute-force interpolation
    of every query, which is what ``knn_backend="pallas"`` pays."""
    def best(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, min(times) * 1e3

    nq = q.shape[0]
    ms = {}
    struct, ms["build"] = best(lambda: grid_knn._build_struct(
        r, GRID_SHAPE, skip_z_sort=True))
    vals_pad, ms["values"] = best(lambda: grid_knn._sorted_values(struct,
                                                                  vals))
    sl, ms["layout+tables"] = best(lambda: grid_knn._layout_slots(
        struct, q, GRID_SHAPE, GRID_TQ, SLOT_CAP))
    (v, d), ms["kernel"] = best(lambda: grid_interp_cuda(
        sl.q_pad, struct.refs_pad, vals_pad, sl.st, sl.en, 3))
    safe, ms["margins"] = best(lambda: grid_knn._safe_rows(struct, sl, d, 3,
                                                           GRID_SHAPE))
    unsafe = ~safe.reshape(-1) & (sl.orig_pad < nq)
    _, ms["sync+patch"] = best(lambda: grid_knn._apply_fallback(
        (v,), unsafe, sl.q_pad, nq, 4096,
        lambda rows: (grid_knn._brute_interp(rows, r, vals, 3, 1e-8),)))
    _, brute_ms = best(lambda: grid_knn._brute_interp(q, r, vals, 3, 1e-8))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grid_knn.grid_knn_interpolate_layout(q, r, vals)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"[grid breakdown] one call at {nq}x{r.shape[0]}, each phase alone "
          f"(host clock, synchronised, best of 5): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; sum {sum(ms.values()):.4f} ms ({int(unsafe.sum())} unsafe "
          f"rows). Whole call profiled: {sum(e.count for e in dev)} device "
          f"kernels, device busy {busy:.4f} ms of {wall:.4f} ms wall. Brute "
          f"interpolation of all {nq} rows: {brute_ms:.4f} ms")


def chamfer_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    d = torch.cdist(a.double(), b.double())
    return ((d.min(dim=1).values.mean() + d.min(dim=0).values.mean()) / 2).item()


def phase_reference(rng: np.random.Generator, dev: torch.device) -> None:
    """Sampler with kernels on the card vs plain versions on the CPU: the
    brute-force kNN at 4,096 points, the grid at 24,576 (its 6,144 coarse
    points are the fewest that engage the default grid)."""
    for n, m, backend in ((4096, 1024, "pallas"), (24576, 6144, "auto")):
        reference_run(rng, dev, n, m, backend)


def reference_run(rng: np.random.Generator, dev: torch.device, n: int,
                  m: int, backend: str) -> None:
    cfg = Config(total_points=n, global_points=m, use_amp=False,
                 knn_backend=backend)
    torch.manual_seed(1)
    net_cpu = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    net_gpu = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    net_gpu.load_state_dict(net_cpu.state_dict())
    src = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])[None]
    cond = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])[None]
    draws = dict(
        x_init=torch.from_numpy(rng.standard_normal((1, n, 3), np.float32)),
        cond_priority=torch.from_numpy(rng.random((1, n), np.float32)),
        step_priorities=torch.from_numpy(rng.random((STEPS, 1, n), np.float32)),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64))
    outs = []
    for device, net in (("cpu", net_cpu), (dev, net_gpu)):
        model = PointCloudDiffusionModel(cfg, device, net=net)
        reset_launch_counts()
        outs.append(guided_sample_loop(
            model, make_schedule(cfg), src, cond, num_inference_steps=STEPS,
            guidance_scale=GUIDANCE,
            **{k: v.to(model.device) for k, v in draws.items()}).cpu())
    counts = dict(LAUNCH_COUNTS)  # the card's run
    want = ({"grid_interp": STEPS} if backend == "auto"
            else {"grid_interp": 0, "knn_topk": STEPS})
    if any(counts[k] != v for k, v in want.items()):
        fail(f"reference ({backend}): launches {counts}, expected {want}")
    cd = chamfer_l2(outs[0][0], outs[1][0])
    max_abs = (outs[0] - outs[1]).abs().max().item()
    if not torch.isfinite(outs[1]).all() or cd > 1e-3:
        fail(f"reference ({backend}): card vs CPU Chamfer-L2 {cd:.3g} "
             "(> 1e-3) or non-finite output")
    print(f"[reference] {n} points / {m} coarse, knn_backend={backend!r}, "
          f"{STEPS} steps, float32: card (kernels, launches {counts}) vs CPU "
          f"(plain) Chamfer-L2 {cd:.3g}, max |d| {max_abs:.3g}")


def phase_main_path(rng: np.random.Generator, dev: torch.device,
                    card: str) -> dict:
    cfg = Config()
    torch.manual_seed(0)
    net = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    params, stats = split_state_dict(net)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "model.pt"), cfg, params,
                               stats)
        src = make_cloud(rng, N_POINTS, dup_frac=0.0)
        ref = make_cloud(rng, N_POINTS, dup_frac=0.0)
        src_path, ref_path = (os.path.join(tmp, f) for f in ("src.npy", "ref.npy"))
        out_path = os.path.join(tmp, "out.npy")
        np.save(src_path, src)
        np.save(ref_path, ref)
        engine = DiffusionInference(ckpt, seed=1, device=dev)
        engine.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)  # warm-up

        reset_launch_counts()
        grid_knn.UNSAFE_COUNTS.clear()
        t0 = time.perf_counter()
        rc = cli_main(["--checkpoint", ckpt, "--source", src_path,
                       "--reference", ref_path, "--output", out_path,
                       "--num_steps", str(STEPS),
                       "--guidance_scale", str(GUIDANCE), "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = dict(LAUNCH_COUNTS)
        unsafe = list(grid_knn.UNSAFE_COUNTS)
        if rc != 0:
            fail(f"inference CLI returned {rc}")
        out = np.load(out_path)
        if out.shape != (N_POINTS, 3) or not np.isfinite(out).all():
            fail(f"output shape {out.shape} / finite "
                 f"{bool(np.isfinite(out).all())}")
        patched = sum(u > 0 for u in unsafe)
        last_tier = grid_knn._fallback_caps(4096, N_POINTS - M_POINTS)[-1]
        expected = {"knn_topk": patched, "fps": 2, "ball_query": 2,
                    "grid_interp": STEPS, "grid_topk": 0}
        if len(unsafe) != STEPS or counts != expected:
            fail(f"launch counts {counts} != {expected} ({len(unsafe)} grid "
                 "passes recorded)")
        if not all(counts[k] for k in ("knn_topk", "fps", "ball_query",
                                       "grid_interp")):
            fail(f"a kernel of the main path was not launched: {counts}")
        print(f"[main] CLI {N_POINTS} points, {STEPS} steps, guidance "
              f"{GUIDANCE}, bf16: output {out.shape} finite; launches {counts}; "
              f"{cli_s:.3f} s including checkpoint load and file IO ({card})")
        print(f"[main] unsafe rows per step (of {N_POINTS - M_POINTS}): min "
              f"{min(unsafe)}, median {int(np.median(unsafe))}, max "
              f"{max(unsafe)}; {patched} steps patched by knn_topk, "
              f"{sum(u > last_tier for u in unsafe)} of them all-brute "
              f"(> {last_tier} rows); per step: {unsafe}")

        brute_ckpt = save_checkpoint(os.path.join(tmp, "brute.pt"),
                                     cfg.replace(knn_backend="pallas"),
                                     params, stats)
        brute = DiffusionInference(brute_ckpt, seed=1, device=dev)
        brute.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)
        for name, eng in (("grid (auto)", engine), ("brute (pallas)", brute)):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                eng.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            best = min(times)
            print(f"[main] {name}: seconds per cloud {best:.4f} (runs "
                  f"{', '.join(f'{t:.4f}' for t in times)}), "
                  f"{N_POINTS / best:.0f} points/s ({card})")

        torch.cuda.reset_peak_memory_stats()
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        print(f"[profile] one cloud: wall {wall * 1e3:.1f} ms (profiled), "
              f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), "
              f"{sum(r[2] for r in rows)} kernel launches, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for key, ms, cnt in rows[:20]:
            print(f"[profile]   {ms:9.3f} ms  x{cnt:<5d} {key[:100]}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    phase_build()
    card = card_line()
    records = phase_kernels(rng, dev)
    phase_reference(rng, dev)
    counts = phase_main_path(rng, dev, card)
    for name, rec in records.items():
        rec.setdefault("launches", counts[name])
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
