#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pointcloud_style_transfer_torch``) on one
NVIDIA GPU. Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases, each printing one line per result:

1. build — compile every CUDA kernel from ``csrc/`` (one nvcc per source, in
   parallel); the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes (numpy-seeded inputs with exact duplicate points,
   to force ties): identical indices, kNN distances within 1e-6 relative;
   kernel, plain, library and bound times.
3. reference — a small cloud through the sampler on the card (kernels) and
   on the CPU (plain versions) with the same draws, float32: Chamfer-L2
   <= 1e-3 between the two.
4. main path — a seeded full-width checkpoint (``Config()`` defaults, bf16),
   120,000-point source and condition clouds, 50 steps at guidance 7.5
   through the inference CLI's ``main``: output shape and finiteness, launch
   counts (50 kNN, 2 FPS, 2 ball query per cloud), seconds per cloud, and a
   profiler breakdown of one cloud.

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
from pointcloud_style_transfer_torch.ops import index_points
from pointcloud_style_transfer_torch.ops.kernels import (
    LAUNCH_COUNTS, ball_query_cuda, ball_query_plain, build_all, fps_cuda,
    fps_plain, knn_topk_cuda, knn_topk_plain, reset_launch_counts)
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
EXPECTED_LAUNCHES = {"knn_topk": STEPS, "fps": 2, "ball_query": 2}


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


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        fail(f"{name}: {bad} of {want.numel()} indices differ from the plain "
             "version")


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
    return records


def chamfer_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    d = torch.cdist(a.double(), b.double())
    return ((d.min(dim=1).values.mean() + d.min(dim=0).values.mean()) / 2).item()


def phase_reference(rng: np.random.Generator, dev: torch.device) -> None:
    """Sampler with kernels on the card vs plain versions on the CPU."""
    n, m = 4096, 1024
    cfg = Config(total_points=n, global_points=m, use_amp=False)
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
        outs.append(guided_sample_loop(
            model, make_schedule(cfg), src, cond, num_inference_steps=STEPS,
            guidance_scale=GUIDANCE,
            **{k: v.to(model.device) for k, v in draws.items()}).cpu())
    cd = chamfer_l2(outs[0][0], outs[1][0])
    max_abs = (outs[0] - outs[1]).abs().max().item()
    if not torch.isfinite(outs[1]).all() or cd > 1e-3:
        fail(f"reference: card vs CPU Chamfer-L2 {cd:.3g} (> 1e-3) or "
             "non-finite output")
    print(f"[reference] {n} points / {m} coarse, {STEPS} steps, float32: card "
          f"(kernels) vs CPU (plain) Chamfer-L2 {cd:.3g}, max |d| {max_abs:.3g}")


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
        t0 = time.perf_counter()
        rc = cli_main(["--checkpoint", ckpt, "--source", src_path,
                       "--reference", ref_path, "--output", out_path,
                       "--num_steps", str(STEPS),
                       "--guidance_scale", str(GUIDANCE), "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = dict(LAUNCH_COUNTS)
        if rc != 0:
            fail(f"inference CLI returned {rc}")
        out = np.load(out_path)
        if out.shape != (N_POINTS, 3) or not np.isfinite(out).all():
            fail(f"output shape {out.shape} / finite "
                 f"{bool(np.isfinite(out).all())}")
        if counts != EXPECTED_LAUNCHES:
            fail(f"launch counts {counts} != {EXPECTED_LAUNCHES}")
        print(f"[main] CLI {N_POINTS} points, {STEPS} steps, guidance "
              f"{GUIDANCE}, bf16: output {out.shape} finite; launches {counts}; "
              f"{cli_s:.3f} s including checkpoint load and file IO ({card})")

        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(f"[main] seconds per cloud {best:.4f} (runs "
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
        for key, ms, cnt in rows[:15]:
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
        rec["launches"] = counts[name]
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
