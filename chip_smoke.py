#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pointcloud_style_transfer_torch``) on one
NVIDIA GPU. Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases, each printing one line per result:

1. build — compile every CUDA kernel from ``csrc/`` (one nvcc per source, in
   parallel) and an empty kernel for the launch floor; each instantiation's
   registers and spill stores (none allowed in any kernel of the port);
   the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
   the main paths' shapes (numpy-seeded inputs with exact duplicate points,
   to force ties): the brute-force kNN's indices and distance bits identical
   at 90,000 x 30,000, at the kd-grid's patch sizes (500 to 32,768 rows)
   and at 30,000 x 30,000 with k = 1, 9 and 16, with its cluster size S,
   one launch per call, and the plan's S against half and double S at each
   shape, and past 16 (k = 17, 32, 64 at 90,000 and 2,500 rows; the
   packed-key, grid and pruned kernels at k = 17 and 32 too); FPS
   identical at 30,000 -> 512, 512 -> 128, 65,536 -> 512, on three lattice
   clouds and, past the registers' cap, at 70,000 and 120,000 -> 512, in us
   per iteration, with its launch (S, threads, PER) against its neighbours
   at four cloud sizes; the ball query at the style encoder's two calls,
   indices identical, in device time beside the scan the data needs (the
   longest row, rows not full, empty rows, pairs scanned) and an empty
   kernel's device time on the same grid; the row minimum at the
   compare CLI's 120,000 x 120,000 and the Chamfer loss's 30,000 x 30,000,
   identical values with a NaN row, in device time, with the source's
   cluster size S and queries a thread Q and the SM clock under load;
   ``MinSqDist`` launching the k=1 kNN under grad and the row
   minimum without, its gradients on the card within 1e-6 of the CPU's;
   the kd-grid's slot-run kernels on slot tables from the grid's own layout
   pass (90,000 queries, 30,000 refs), with and without its real-row
   counts and with NaN refs of both signs: distances and positions
   identical on every row, values within rtol 1e-6, atol 1e-6 * max|v|,
   pairs needed against pairs scanned, the staging chunk against half and
   double it; the grid's interpolation
   after its fallback against the brute-force interpolation, and
   ``knn(backend="grid")`` (its own path, launch counts read around it)
   against the brute-force kNN; the packed-key kNN kernels (raw keys,
   decoded indices and recomputed distances identical to the plain
   versions at 90,000 x 30,000 and on a 2,500-row patch, every departure
   from the exact kernel a near-tie; in device time, each with its plan's
   cluster size S) and the pruned kNN (both passes
   identical to the plain version, the result's distances identical to the
   brute-force kernel's, the tile pairs skipped and the pairs visited,
   which its bound counts, the least, mean and largest count of unskipped
   ref tiles a query tile in each pass, the pairs its warps' chunk box
   test leaves to scan; each pass in device time, with the source's
   cluster size S);
   ``grid_knn(exact=False)``; kernel, plain, library and bound times.
3. reference — clouds through the sampler on the card (kernels) and on the
   CPU (plain versions) with the same draws, float32: 4,096 points with the
   brute-force kNN, and 24,576 points with ``knn_backend="auto"``, where
   6,144 coarse points engage the grid. The CPU run records its discrete
   choices (each step's voxel order, the upsample's neighbours); the card
   replays them, Chamfer-L2 <= 1e-3 to the CPU; the card's own choices on
   the CPU's inputs of every step are the CPU's but for near-ties; the
   card's own run (its launch counts held) is printed beside. The first case
   also step by step (``[reference trace]``: the first step at which a
   discrete choice of the card departs, with its margin, each stage's
   largest card-vs-CPU difference before it, the library versions). The
   coarse displacement sampler (``--fast``) at 4,096 points, whose choices
   depend on the inputs alone: its own run, Chamfer-L2 <= 1e-3.
4. main path — a seeded full-width checkpoint (``Config()`` defaults, bf16,
   ``knn_backend="auto"``: the kd-grid), 120,000-point source and condition
   clouds, 50 steps at guidance 7.5 through the inference CLI's ``main``:
   output shape and finiteness, launch counts (50 grid interpolations, one
   brute-force patch for each step with unsafe rows, 2 FPS, 2 ball query
   per cloud), the per-step unsafe counts, seconds per cloud for the grid
   and for the brute-force kNN (``knn_backend="pallas"``), and a profiler
   breakdown of one grid cloud. Then the other serving paths at the same
   width, each with its launch counts asserted and its seconds per cloud:
   ``knn_backend="pallas_f32packed"`` and
   ``"pallas_pruned"``, ``--fast`` (one ``grid_topk``, at most one brute
   patch), ``--source_dir`` with 3 clouds at ``--batch_size 2``, and
   ``ddim_sample_loop`` for 5 steps.
5. train — ``Config()`` defaults, nothing cut: four synthetic 120,000-point
   scene pairs through ``cli.preprocess`` (3 train, 1 val), then 2 epochs of
   ``cli.train`` (6 mini-steps, 2 optimizer steps, 2 validations, 2
   checkpoints): parameters and EMA move only on the 3rd and 6th mini-step,
   finite loss terms, launches per mini-step (2 kNN for the Chamfer's
   gradient, 2 FPS, 2 ball query, no row minimum), ms per mini-step and per
   optimizer step, peak memory; a resumed trainer starts at epoch 2 with
   the same state; a profiled mini-step; one float32 mini-step at 4,096
   points on the card and on the CPU with the same draws, the card
   replaying the CPU step's discrete selections (ReLU gates, max-pool
   argmaxes, Chamfer argmins): loss and gradients at the CPU tests'
   tolerances; the card's step with its own selections: every one that
   differs from the CPU's a near-tie, and few; for three clouds and draws
   from generators of its own.
6. eval — ``cli.inference`` from the trained ``best_model`` directory (the
   grid path), ``cli.compare --json`` of its output against the val pair's
   reference (4 row-min launches, the JAX package's JSON keys), and the
   metrics suite on the output.
7. test — ``cli.test`` from ``best_model`` on a test split of two synthetic
   120,000-point pairs at ``--batch_size 2``: sim->real and real->sim, 50
   steps, every metric, generated clouds and plots saved; its launches
   asserted (200 grid interpolations, 4 FPS, 4 ball queries, 14 row
   minima, the patches and two k=9 kNN); seconds per batch and the EMD's
   peak memory; its metrics held to the CPU's recomputation from the saved
   clouds (float64 nearest neighbours and Sinkhorn on the card run's
   subsample permutations; rtol 1e-4, coverage 1e-4 absolute, EMD 1e-3).
8. visualize — ``cli.visualize`` on the eval phase's clouds: a PNG and a
   120,000-vertex PLY.
9. progress — ``cli.progress`` over the train phase's two epochs at 50
   steps, launches asserted.
10. benchmark — ``cli.benchmark --reps 2`` at ``Config()`` sizes (forward
    sweep, hierarchical vs direct, scaling, 50-step sampling at B = 1, 2,
    4, 8), keys, finite values and launches asserted, its JSON printed.
11. train augmentation — one ``Config(use_augmentation=True)`` mini-step
    on the card: its draws printed, the augmentation card vs CPU within
    1e-6, a finite loss, the step's launches.
12. parallel — ``parallel/`` on a one-rank NCCL group (NCCL puts no two
    ranks on one GPU; multi-card runs are unverified): the ring row
    minimum, kNN (k=3) and evaluation Chamfer at 120,000 x 120,000,
    identical to the dense calls, with 1 ``rowmin``, 1 ``knn_topk`` and 2
    ``rowmin`` launches; ``guided_sample_loop_sharded`` and
    ``guided_sample_loop_dp`` at 120,000 / 30,000 points, 50 steps,
    guidance 7.5 on the grid, identical to ``guided_sample_loop`` with the
    same draws and with its launches, seconds per cloud in turns;
    ``DiffusionTrainer(mesh_shape={"data": 1})`` against the single-device
    trainer for 3 float32 mini-steps at ``Config()`` width: loss terms
    within 1e-5, the accumulated gradients at ``GRAD_RTOL``.

Then one JSON line with every kernel's numbers (``launches`` on the main
path, ``cli_test_launches`` in the test phase, ``parallel_launches`` by
``[parallel]`` path), the ``nvidia-smi`` name and power-limit line, and the
final JSON line. Without a card (or without the
package beside it) it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pointcloud_style_transfer_torch.cli.compare import main as compare_main
from pointcloud_style_transfer_torch.cli.inference import (DiffusionInference,
                                                           main as cli_main)
from pointcloud_style_transfer_torch.cli.preprocess import \
    main as preprocess_main
from pointcloud_style_transfer_torch.cli.train import main as train_main
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.data import (PointCloudPreprocessor,
                                                  create_dataloaders,
                                                  normalize_point_cloud)
from pointcloud_style_transfer_torch.data.synthetic import lidar_scene_pair
from pointcloud_style_transfer_torch.evaluation import metrics
from pointcloud_style_transfer_torch.models import (
    DiffusionNet, PointCloudDiffusionModel, ddim_sample_loop, ddim_step,
    ddim_timesteps, dtype_of, guided_sample_loop, guided_sample_loop_coarse,
    make_schedule, networks, samplers, time_embedding)
from pointcloud_style_transfer_torch.ops import (
    brute_knn, chamfer_distance, farthest_point_sample, grid_knn,
    index_points, knn, min_sq_dist, pruned_knn, query_ball_point,
    voxel_downsample, voxel_downsample_partition)
from pointcloud_style_transfer_torch.ops.voxel import (voxel_geometry,
                                                       voxel_order)
from pointcloud_style_transfer_torch.ops.kernels import (
    LAUNCH_COUNTS, ball_query_cuda, ball_query_plain, build_all, fps_cuda,
    fps_plain, grid_interp_cuda, grid_interp_plain, grid_topk_cuda,
    grid_topk_plain, knn_f32packed_keys_cuda, knn_f32packed_keys_plain,
    knn_intpacked_keys_cuda, knn_intpacked_keys_plain, knn_pruned_pass_cuda,
    knn_pruned_pass_plain, knn_topk_cuda, knn_topk_plain, reset_launch_counts,
    rowmin_cuda, rowmin_plain)
from pointcloud_style_transfer_torch.ops.kernels import knn_packed
from pointcloud_style_transfer_torch.ops.kernels.fps import (
    CLUSTER_SIZES as FPS_CLUSTER_SIZES, MAX_POINTS as FPS_MAX_POINTS,
    MAX_THREADS as FPS_MAX_THREADS, PERS, STREAM, fps_plan)
from pointcloud_style_transfer_torch.ops.kernels.knn import (
    CLUSTER_SIZES, knn_topk_plan)
from pointcloud_style_transfer_torch.ops.kernels._common import (
    BUILD_ROOT, NVCC_FLAGS, library_path, nvcc_path, pairwise_sq_dist,
    source_define)
from pointcloud_style_transfer_torch.ops.kernels.ball_query import \
    radius_sq_f32
from pointcloud_style_transfer_torch.training import (DiffusionTrainer,
                                                      compute_losses)
from pointcloud_style_transfer_torch.utils.checkpoint import (
    save_checkpoint, split_state_dict)

# H100 SXM published peaks (dense): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations issued one at a time, no FMA (the distance kernels'
# contract): 132 SMs x 128 FP32 lanes x 1.98 GHz
NO_FMA_OPS = 132 * 128 * 1.98e9

N_POINTS, M_POINTS = 120_000, 30_000
# csrc/ball_query.cu's warps per block and 32-point steps a warp loads a
# round; csrc/rowmin.cu's blocks per cluster and queries a thread
BQ_WARPS = source_define("ball_query", "PCST_BQ_WARPS")
BQ_UNROLL = source_define("ball_query", "PCST_BQ_UNROLL")
ROWMIN_S = source_define("rowmin", "PCST_ROWMIN_S")
ROWMIN_Q = source_define("rowmin", "PCST_ROWMIN_Q")
# csrc/knn_pruned.cu's blocks per cluster and refs a staging chunk (the
# f32-packed kernel's cluster size is knn_topk_plan's)
PRUNED_S = source_define("knn_pruned", "PCST_PRUNED_S")
PRUNED_CHUNK = source_define("knn_pruned", "PCST_PRUNED_CHUNK")
STEPS, GUIDANCE = 50, 7.5
# the grid's defaults, which the sampler uses
GRID_SHAPE, GRID_TQ, SLOT_CAP = (16, 12, 8), 128, 384


def expect_counts(**launched: int) -> dict:
    """Every kernel's launch count, 0 where not named."""
    return {name: 0 for name in LAUNCH_COUNTS} | launched


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


def device_ms(fn, name: str, reps: int = 30) -> float:
    """Mean device time in ms of the kernel each call of ``fn`` launches
    whose name contains ``name``, over the launches the profiler's trace
    holds (it may drop one): the kernel's own time. ``cuda_ms`` times
    back-to-back calls, which the wrapper's host time paces once the kernel
    is shorter than it (~0.05-0.08 ms). A trace that holds fewer than half
    of the launches (the card's tracer has once kept 10 of 30) is taken
    again, at most twice, and noted on stderr."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in events)
        if reps // 2 <= count <= reps:
            return sum(e.self_device_time_total for e in events) / 1e3 / count
        print(f"device_ms: {count} '{name}' kernels traced in {reps} calls "
              f"(trace {attempt + 1} of at most 3)", file=sys.stderr)
    fail(f"device_ms: {count} '{name}' kernels traced in {reps} calls")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def no_fma_ms(n_ops: float) -> float:
    """The operations' least time when none may be fused into an FMA."""
    return n_ops / NO_FMA_OPS * 1e3


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


def kernel_name(mangled: str) -> str:
    """A kernel's name in its mangled symbol, template arguments written
    out (``knn_topk_kernel<3>``). The name is the ``*_kernel`` identifier
    whose length is the digits before it; the anonymous namespace may put
    a hexadecimal hash that ends in digits right before those."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(len(run.group())):
            end = run.end() + int(run.group()[i:])
            ident = mangled[run.end():end]
            if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", ident):
                args = re.match(r"I((?:Li\d+E)+)E", mangled[end:])
                args = re.findall(r"Li(\d+)E", args.group(1)) if args else []
                return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_usage(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) per entry function of an
    ``-Xptxas -v`` log; template arguments written out, e.g. ``<3,4>``."""
    rows, name, spill = [], None, 0
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            name, spill = kernel_name(entry.group(1)), 0
            continue
        found = re.search(r"(\d+) bytes spill stores", ln)
        if found and name:
            spill = int(found.group(1))
        found = re.search(r"Used (\d+) registers", ln)
        if found and name:
            rows.append((name, int(found.group(1)), spill))
            name = None
    return rows


# the kernels whose every instantiation must keep its state in registers
NO_SPILL_SOURCES = ("knn_topk", "fps", "grid_fused", "ball_query", "rowmin",
                    "knn_packed", "knn_pruned")


# an empty kernel, the launch floor of the ball query's grid; built beside
# the port's kernels and kept out of the package
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int pcst_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
EMPTY_LIB = BUILD_ROOT / "launch_floor" / "libempty.so"


def phase_build() -> None:
    t0 = time.perf_counter()
    EMPTY_LIB.parent.mkdir(parents=True, exist_ok=True)
    (EMPTY_LIB.parent / "empty.cu").write_text(EMPTY_SOURCE)
    empty = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(EMPTY_LIB),
         str(EMPTY_LIB.parent / "empty.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    paths = build_all()
    if empty.wait():
        fail(f"empty kernel: nvcc failed\n{empty.stdout.read().decode()}")
    dt = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernels built in {dt:.1f}s into {BUILD_ROOT}")
    for name in paths:
        usage = ptxas_usage(library_path(name).with_suffix(".log").read_text())
        print(f"[build] {name} ptxas (registers, spill-store bytes): " + ", ".join(
            f"{k} {r}/{s}" for k, r, s in usage))
        spilled = [k for k, _, s in usage if s]
        if name in NO_SPILL_SOURCES and (spilled or not usage):
            fail(f"{name}: spill stores in {spilled} (or no ptxas report)")
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
    check_equal("knn_topk", d_k.view(torch.int32), d_p.view(torch.int32),
                "distance bits")
    ms = cuda_ms(lambda: knn_topk_cuda(query, ref, 3), reps=20)
    plain_ms = cuda_ms(lambda: knn_topk_plain(query, ref, 3), reps=2)

    def library():
        q, r = query[0], ref[0]
        for s in range(0, q.shape[0], 8192):
            torch.topk(torch.cdist(q[s:s + 8192], r), 3, largest=False)
    lib_ms = cuda_ms(library, reps=3)
    nq, m = query.shape[1], ref.shape[1]
    b_ms, b_by = bound_ms((nq + m) * 12 + nq * 3 * 8, 8.0 * nq * m)
    plan = knn_topk_plan(1, nq, m)
    records["knn_topk"] = dict(
        name="knn_topk", route="cuda",
        source="pointcloud_style_transfer_torch/csrc/knn_topk.cu",
        replaces="pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py:40",
        shape=f"{nq}x{m} k=3", plan=dict(S=plan),
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, bound_no_fma_ms=no_fma_ms(8.0 * nq * m),
        library_ms=lib_ms)
    print(f"[kernels] knn_topk {nq}x{m} k=3, plan S={plan}: "
          f"indices and distance bits identical; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, library (cdist+topk) {lib_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; no-FMA {no_fma_ms(8.0 * nq * m):.4f} ms)")

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
        print(f"[kernels] fps {n}->{npoint}, plan (S, threads, PER) "
              f"{fps_plan(n)}: indices identical; kernel {ms:.4f} ms "
              f"({1e3 * ms / npoint:.3f} us per iteration), plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}; latency-bound "
              f"by {npoint} dependent argmaxes)")
        if npoint == 512:
            records["fps"] = dict(
                name="fps", route="cuda",
                source="pointcloud_style_transfer_torch/csrc/fps.cu",
                replaces="pointcloud_style_transfer_tpu/ops/pallas/fps.py:31",
                shape=f"{n}->{npoint}",
                plan=dict(zip(("S", "threads", "PER"), fps_plan(n))),
                us_per_iteration=1e3 * ms / npoint, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
        xyz = index_points(xyz, got).contiguous()
    # what 512 iterations cost where no pass over a large cloud is needed:
    # the 512-point call's time per iteration
    records["fps"]["latency_floor_ms"] = 512 * ms / 128
    print(f"[kernels] fps latency floor for 512 iterations (the 512-point "
          f"call's time per iteration): {512 * ms / 128:.4f} ms")

    # -- ball query at the encoder's two calls --
    records["ball_query"] = phase_ball_query(fps_rows)
    phase_fps_plans(ref, records["fps"])
    records["rowmin"] = phase_rowmin(rng, dev)
    phase_min_sq_dist(rng, dev)
    phase_knn_plans(query, ref, records["knn_topk"])
    phase_knn_large_k(query[:, :M_POINTS].contiguous(), ref)
    past_16 = phase_knn_past_16(query, ref, records["knn_topk"])
    records.update(phase_grid_kernels(rng, query, ref))
    records.update(phase_packed_kernels(query, ref, records["knn_topk"]))
    records["knn_pruned"] = phase_pruned_kernel(query, ref,
                                                records["knn_topk"])
    for name, times in past_16.items():
        records[name]["k_past_16_ms"] = times
    phase_grid_inexact(query, ref)
    return records


def empty_kernel_ms(blocks: int) -> float:
    """Device time of an empty kernel on ``blocks`` blocks of the ball
    query's threads: the launch floor no launch of that grid gets under."""
    lib = ctypes.CDLL(str(EMPTY_LIB))
    lib.pcst_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def run():
        rc = lib.pcst_empty(blocks, BQ_WARPS * 32,
                            torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"empty kernel: launch error {rc}")
    return device_ms(run, "empty_kernel")


def phase_ball_query(fps_rows: list) -> dict:
    """The ball query at the encoder's two calls (the FPS centers of the
    30,000-point cloud, r 0.2, ns 32; of its 512 centers, r 0.4, ns 64):
    indices identical to the plain version; the scan this data needs (each
    center's ends at its ns-th hit: the longest row, rows not full, empty
    rows, pairs scanned); device time against the operations bound, the
    no-FMA bound and an empty kernel's device time on the same grid."""
    record = {}
    for (points, sel), radius, ns in zip(fps_rows, (0.2, 0.4), (32, 64)):
        centers = index_points(points, sel).contiguous()
        got = ball_query_cuda(radius, ns, points, centers)
        want = ball_query_plain(radius, ns, points, centers)
        torch.cuda.synchronize()
        s, n = centers.shape[1], points.shape[1]
        check_equal(f"ball_query {s}x{n}", got, want)
        inside = pairwise_sq_dist(centers[0], points[0]) <= radius_sq_f32(radius)
        hits = torch.cumsum(inside.int(), dim=1)
        full = hits[:, -1] >= ns
        scan = torch.where(full, torch.argmax((hits >= ns).int(), dim=1) + 1, n)
        pairs = scan.sum().item()
        empty = (~inside.any(dim=1)).sum().item()
        ms = device_ms(lambda: ball_query_cuda(radius, ns, points, centers),
                       "ball_query_kernel")
        plain_ms = cuda_ms(lambda: ball_query_plain(radius, ns, points,
                                                    centers), reps=3)
        b_ms, b_by = bound_ms((s + n) * 12 + s * ns * 4, 9.0 * pairs)
        nf_ms = no_fma_ms(9.0 * pairs)
        floor = empty_kernel_ms(s)
        print(f"[kernels] ball_query {s}x{n} r={radius} ns={ns} ({BQ_WARPS} "
              f"warps x {BQ_UNROLL} steps a round): indices identical; "
              f"longest row scan {int(scan.max())} points, "
              f"{s - int(full.sum())} rows not full, {empty} empty, {pairs} "
              f"pairs scanned; device {ms:.5f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}; no-FMA {nf_ms:.6f} ms), launch "
              f"floor (an empty kernel on {s} blocks) {floor:.5f} ms")
        if ns == 32:
            record = dict(
                name="ball_query", route="cuda",
                source="pointcloud_style_transfer_torch/csrc/ball_query.cu",
                replaces="pointcloud_style_transfer_tpu/ops/pallas/"
                         "distance_topk.py:371",
                shape=f"{s}x{n} r={radius} ns={ns}",
                plan=dict(warps=BQ_WARPS, unroll=BQ_UNROLL),
                longest_scan=int(scan.max()), max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_no_fma_ms=nf_ms, launch_floor_ms=floor,
                library_ms=None)
        else:
            record["ms_second_call"] = ms
    return record


def clocks_under_load(fn, launches: int) -> list[str]:
    """``nvidia-smi``'s SM clock, its maximum and the power draw, read three
    times while the card works through ``launches`` queued calls of
    ``fn``."""
    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    reads = [subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() for _ in range(3)]
    torch.cuda.synchronize()
    return reads


def phase_rowmin(rng: np.random.Generator, dev: torch.device) -> dict:
    """The row minimum at the compare CLI's shape (120,000 x 120,000) and
    the Chamfer loss's (30,000 x 30,000): values identical to the plain
    version, with exact duplicates, zero distances and one NaN query row;
    device time. The cluster size S and the queries a thread Q are the
    source's (``tools/sweep_kernel_plans.py`` times the others)."""
    record = {}
    for n in (N_POINTS, M_POINTS):
        a = normalize_point_cloud(make_cloud(rng, n))[0]
        b = normalize_point_cloud(make_cloud(rng, n))[0]
        a[:500] = b[rng.choice(n, 500)]
        a[777, 1] = np.nan
        q = torch.from_numpy(a)[None].to(dev)
        r = torch.from_numpy(b)[None].to(dev)
        want = rowmin_plain(q, r)
        nan = torch.isnan(want)
        got = rowmin_cuda(q, r)
        torch.cuda.synchronize()
        if (not torch.equal(torch.isnan(got), nan) or int(nan.sum()) != 1
                or not torch.equal(got[~nan], want[~nan])):
            fail(f"rowmin {n}x{n}: values differ from the plain version")
        ms = device_ms(lambda: rowmin_cuda(q, r), "rowmin", reps=10)
        plain_ms = cuda_ms(lambda: rowmin_plain(q, r), reps=1, warmup=0)

        def library():
            for s in range(0, n, 8192):
                torch.cdist(q[0, s:s + 8192], r[0]).amin(dim=1)
        lib_ms = cuda_ms(library, reps=3)
        b_ms, b_by = bound_ms(2 * n * 12 + n * 4, 8.0 * n * n)
        nf_ms = no_fma_ms(8.0 * n * n)
        print(f"[kernels] rowmin {n}x{n}, S={ROWMIN_S}, Q={ROWMIN_Q}: values "
              f"identical (NaN row kept); device {ms:.4f} ms "
              f"({100 * nf_ms / ms:.1f}% of the no-FMA bound), plain "
              f"{plain_ms:.3f} ms, library (chunked cdist + amin) "
              f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; no-FMA "
              f"{nf_ms:.4f} ms)")
        if n == N_POINTS:
            print("[kernels] rowmin under load, nvidia-smi (SM clock, max SM "
                  "clock, power draw): " + "; ".join(clocks_under_load(
                      lambda: rowmin_cuda(q, r), 300)))
            record = dict(
                name="rowmin", route="cuda",
                source="pointcloud_style_transfer_torch/csrc/rowmin.cu",
                replaces="pointcloud_style_transfer_tpu/ops/pallas/"
                         "distance_topk.py:152",
                shape=f"{n}x{n}", plan=dict(S=ROWMIN_S, Q=ROWMIN_Q),
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bound_no_fma_ms=nf_ms, library_ms=lib_ms)
        else:
            record["ms_chamfer_shape"] = ms
    return record


def phase_min_sq_dist(rng: np.random.Generator, dev: torch.device) -> None:
    """``MinSqDist``: the squared Chamfer at the loss's 30,000 x 30,000 runs
    the k=1 kNN once per direction under grad and the row minimum without;
    its gradients on the card against the CPU's plain path at 8,192 points
    (the card's scatter-add into the refs uses atomics)."""
    a = normalize_point_cloud(make_cloud(rng, M_POINTS))[0]
    b = normalize_point_cloud(make_cloud(rng, M_POINTS))[0]
    p = torch.from_numpy(a)[None].to(dev).requires_grad_()
    t = torch.from_numpy(b)[None].to(dev)
    reset_launch_counts()
    loss = chamfer_distance(p, t).mean()
    torch.cuda.synchronize()
    with_grad = dict(LAUNCH_COUNTS)
    loss.backward()
    reset_launch_counts()
    with torch.no_grad():
        chamfer_distance(p, t)
    torch.cuda.synchronize()
    without = dict(LAUNCH_COUNTS)
    if (with_grad["knn_topk"], with_grad["rowmin"]) != (2, 0) or (
            without["knn_topk"], without["rowmin"]) != (0, 2):
        fail(f"MinSqDist launches: under grad {with_grad}, without {without}")
    if not torch.isfinite(p.grad).all():
        fail("MinSqDist: non-finite gradient")

    n = 8192
    q_np = normalize_point_cloud(make_cloud(rng, n))[0]
    r_np = normalize_point_cloud(make_cloud(rng, n))[0]
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (1, n)).astype(np.float32))
    res = []
    for device in ("cpu", dev):
        q = torch.from_numpy(q_np)[None].to(device).requires_grad_()
        r = torch.from_numpy(r_np)[None].to(device).requires_grad_()
        val = torch.sum(w.to(device) * min_sq_dist(q, r))
        val.backward()
        res.append((val.item(), q.grad.cpu(), r.grad.cpu()))
    (v_c, dq_c, dr_c), (v_g, dq_g, dr_g) = res
    errs = []
    for got, want in ((dq_g, dq_c), (dr_g, dr_c)):
        tol = 1e-6 * want.abs().max() + 1e-6 * want.abs()
        if not ((got - want).abs() <= tol).all():
            fail("MinSqDist: card gradients differ from the CPU's beyond 1e-6")
        errs.append((got - want).abs().max().item())
    if abs(v_g - v_c) > 1e-6 * abs(v_c):
        fail(f"MinSqDist: card value {v_g} vs CPU {v_c}")
    print(f"[kernels] MinSqDist {M_POINTS}x{M_POINTS} Chamfer: under grad "
          f"knn_topk {with_grad['knn_topk']} / rowmin {with_grad['rowmin']}, "
          f"without grad knn_topk {without['knn_topk']} / rowmin "
          f"{without['rowmin']}; {n}x{n} card vs CPU: value rel err "
          f"{abs(v_g - v_c) / abs(v_c):.3g}, max |dq| err {errs[0]:.3g}, "
          f"max |dr| err {errs[1]:.3g}")


def knn_neighbours(q: torch.Tensor, ref: torch.Tensor, k: int,
                   d: torch.Tensor, i: torch.Tensor) -> str:
    """The plan's cluster size against its neighbours (half and double):
    each result identical to the plan's (``d``, ``i``), ms per launch."""
    plan = knn_topk_plan(1, q.shape[1], ref.shape[1])
    times = {}
    for S in (plan // 2, plan, 2 * plan):
        if S not in CLUSTER_SIZES:
            continue
        d2, i2 = knn_topk_cuda(q, ref, k, plan=S)
        torch.cuda.synchronize()
        what = f"knn_topk {q.shape[1]}x{ref.shape[1]} k={k} S={S}"
        check_equal(what, i2, i)
        check_equal(what, d2.view(torch.int32), d.view(torch.int32),
                    "distance bits")
        times[S] = cuda_ms(lambda: knn_topk_cuda(q, ref, k, plan=S), reps=10)
    best = min(times, key=times.get)
    return ("; plan vs neighbours, ms: " + ", ".join(
        f"S={S} {t:.4f}" for S, t in times.items())
        + ("" if best == plan else f" (S={best} faster)"))


def phase_knn_past_16(query: torch.Tensor, ref: torch.Tensor,
                      record: dict) -> dict:
    """The kNN kernel past the register lists' k = 16 (its global-list
    kernel, no cluster) at k = 17, 32 and 64, at the brute path's 90,000 x
    30,000 and on a 2,500-row patch: one launch per call, indices and
    distance bits identical to the plain version. Then the packed-key,
    grid and pruned kernels' global-list variants (``past_16_others``);
    returns their records by kernel."""
    rng = np.random.default_rng(7)  # the phase's own, as below
    m = ref.shape[1]
    patch = query[:, torch.from_numpy(np.sort(rng.choice(
        query.shape[1], 2500, replace=False))).to(query.device)].contiguous()
    record["k_past_16"] = {}
    for k in (17, 32, 64):
        for q in (query, patch):
            nq = q.shape[1]
            before = LAUNCH_COUNTS["knn_topk"]
            d, i = knn_topk_cuda(q, ref, k)
            launches = LAUNCH_COUNTS["knn_topk"] - before
            d_p, i_p = knn_topk_plain(q, ref, k)
            torch.cuda.synchronize()
            what = f"knn_topk {nq}x{m} k={k}"
            if launches != 1:
                fail(f"{what}: {launches} launches for one call")
            check_equal(what, i, i_p)
            check_equal(what, d.view(torch.int32), d_p.view(torch.int32),
                        "distance bits")
            ms = cuda_ms(lambda: knn_topk_cuda(q, ref, k), reps=5)
            b_ms, b_by = bound_ms((nq + m) * 12 + nq * k * 8, 8.0 * nq * m)
            record["k_past_16"][f"{nq}x{m} k={k}"] = dict(
                ms=ms, bound_ms=b_ms, bound_no_fma_ms=no_fma_ms(8.0 * nq * m))
            print(f"[kernels] {what} (global lists, no cluster): indices and "
                  f"distance bits identical, 1 launch; kernel {ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}; no-FMA "
                  f"{no_fma_ms(8.0 * nq * m):.4f} ms)")
    return past_16_others(query, ref, patch)


def one_launch(name: str, fn):
    """``fn()``'s result, failing unless it launched ``name`` once."""
    before = LAUNCH_COUNTS[name]
    out = fn()
    if LAUNCH_COUNTS[name] - before != 1:
        fail(f"{name}: {LAUNCH_COUNTS[name] - before} launches for one call")
    return out


def past_16_others(query: torch.Tensor, ref: torch.Tensor,
                   patch: torch.Tensor) -> dict:
    """The packed-key kernels (90,000 and 2,500 rows x 30,000 refs), the
    grid kernels (the sampler's tables at 90,000 x 30,000) and both pruned
    passes (90,000 x 30,000, default tiles) at k = 17 and 32, where their
    lists leave the registers: one launch a call, results identical to
    the plain versions (keys, distance bits, positions; the interpolated
    values within rtol 1e-6, atol 1e-6 * max|v|), each timed once more
    (events)."""
    out = {name: {} for name in ("knn_f32packed", "knn_packed", "grid_interp",
                                 "grid_topk", "knn_pruned")}
    m = ref.shape[1]
    rng = np.random.default_rng(11)  # the phase's own
    struct, sl = grid_tables(query, ref)
    vals = grid_knn._sorted_values(struct, torch.from_numpy(
        rng.standard_normal((m, 3)).astype(np.float32)).to(ref.device))
    tables = (sl.q_pad, struct.refs_pad)
    qs, rs, _, _ = pruned_knn.sort_and_pad(query[0], ref[0], 512, 2048)
    nq, nr = qs.shape[0] // 512, rs.shape[0] // 2048
    in_window = pruned_knn.window_mask(nq, nr, 2, qs.device)
    for k in (17, 32):
        for name, tr in (("knn_f32packed", 4096), ("knn_packed", 2048)):
            kernel, plain = PACKED[name][:2]
            for q in (query, patch):
                m_t = knn_packed.padded_refs(m, tr if q is query else 2048)
                keys = one_launch(name, lambda: kernel(q, ref, k, m_t))
                check_equal(f"{name} {q.shape[1]}x{m} k={k}",
                            keys.view(torch.int32),
                            plain(q, ref, k, m_t).view(torch.int32),
                            "raw keys")
                out[name][f"{q.shape[1]}x{m} k={k}"] = cuda_ms(
                    lambda: kernel(q, ref, k, m_t), reps=1)
        v, d = one_launch("grid_interp", lambda: grid_interp_cuda(
            *tables, vals, sl.st, sl.en, k, n_real=sl.n_real))
        d_t, i_t = one_launch("grid_topk", lambda: grid_topk_cuda(
            *tables, sl.st, sl.en, k, n_real=sl.n_real))
        v_p, d_p = grid_interp_plain(*tables, vals, sl.st, sl.en, k,
                                     n_real=sl.n_real)
        d_tp, i_tp = grid_topk_plain(*tables, sl.st, sl.en, k,
                                     n_real=sl.n_real)
        for what, got, want in (("grid_interp", d, d_p),
                                ("grid_topk", d_t, d_tp)):
            check_equal(f"{what} k={k}", got.view(torch.int32),
                        want.view(torch.int32), "distance bits")
        check_equal(f"grid_topk k={k}", i_t, i_tp, "positions")
        full = d_p[:, -1] < 1e29
        if not np.isfinite(values_err(v[full], v_p[full])):
            fail(f"grid_interp k={k}: values differ from the plain version")
        out["grid_interp"][f"k={k}"] = cuda_ms(lambda: grid_interp_cuda(
            *tables, vals, sl.st, sl.en, k, n_real=sl.n_real), reps=1)
        out["grid_topk"][f"k={k}"] = cuda_ms(lambda: grid_topk_cuda(
            *tables, sl.st, sl.en, k, n_real=sl.n_real), reps=1)
        d0 = qs.new_full((qs.shape[0], k), 1e30)
        i0 = torch.zeros((qs.shape[0], k), dtype=torch.int32,
                         device=qs.device)
        skip = (~in_window).int().contiguous()
        state = (d0, i0)
        for p in (1, 2):
            got = one_launch("knn_pruned", lambda: knn_pruned_pass_cuda(
                qs, rs, skip, *state, k, 512, 2048))
            want = knn_pruned_pass_plain(qs, rs, skip, *state, k, 512, 2048)
            check_equal(f"knn_pruned pass {p} k={k}", got[0].view(torch.int32),
                        want[0].view(torch.int32), "distance bits")
            check_equal(f"knn_pruned pass {p} k={k}", got[1], want[1],
                        "positions")
            out["knn_pruned"][f"pass {p} k={k}"] = cuda_ms(
                lambda: knn_pruned_pass_cuda(qs, rs, skip, *state, k, 512,
                                             2048), reps=1)
            skip = (pruned_knn.prune_mask(qs, rs, got[0], k, 512, 2048)
                    | in_window).int().contiguous()
            state = got
    for name, times in out.items():
        print(f"[kernels] {name} past k = 16 (global lists, no cluster): "
              "identical to the plain version, 1 launch a call; ms (events, "
              "one call): " + ", ".join(f"{key} {t:.4f}"
                                        for key, t in times.items()))
    return out


def phase_knn_large_k(query: torch.Tensor, ref: torch.Tensor) -> None:
    """The kNN kernel at 30,000 x 30,000 with k = 1 (the Chamfer gradient's
    shape), 9 (``uniformity_score``'s k + 1) and the register lists' cap 16:
    indices and distance bits identical to the plain version, the plan
    against its neighbours."""
    nq, m = query.shape[1], ref.shape[1]
    for k in (1, 9, 16):
        d, i = knn_topk_cuda(query, ref, k)
        d_p, i_p = knn_topk_plain(query, ref, k)
        torch.cuda.synchronize()
        check_equal(f"knn_topk k={k}", i, i_p)
        check_equal(f"knn_topk k={k}", d.view(torch.int32),
                    d_p.view(torch.int32), "distance bits")
        ms = cuda_ms(lambda: knn_topk_cuda(query, ref, k), reps=10)
        b_ms, b_by = bound_ms((nq + m) * 12 + nq * k * 8, 8.0 * nq * m)
        print(f"[kernels] knn_topk {nq}x{m} k={k}, plan S="
              f"{knn_topk_plan(1, nq, m)}: indices and distance bits "
              f"identical; kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"no-FMA {no_fma_ms(8.0 * nq * m):.4f} ms)"
              + knn_neighbours(query, ref, k, d, i))


# the kd-grid's patch sizes: the sampler's median ~1,825 unsafe rows up to
# its last fallback tier, 32,768 rows
PATCH_ROWS = (500, 1825, 2500, 4096, 16384, 32768)


def phase_knn_plans(query: torch.Tensor, ref: torch.Tensor,
                    record: dict) -> None:
    """``knn_topk`` at the kd-grid's patch sizes x 30,000 refs and at the
    brute path's 90,000 x 30,000, k = 3: indices and distance bits identical
    to the plain version, one launch per call, ms per launch against the
    bounds, and the plan against its neighbours."""
    rng = np.random.default_rng(5)  # the phase's own: later phases keep
    # their clouds whatever this phase draws
    nq, m, k = query.shape[1], ref.shape[1], 3
    shapes = [query[:, torch.from_numpy(np.sort(rng.choice(
        nq, rows, replace=False))).to(query.device)].contiguous()
        for rows in PATCH_ROWS] + [query]
    for q in shapes:
        rows = q.shape[1]
        plan = knn_topk_plan(1, rows, m)
        before = LAUNCH_COUNTS["knn_topk"]
        d, i = knn_topk_cuda(q, ref, k)
        launches = LAUNCH_COUNTS["knn_topk"] - before
        if launches != 1:
            fail(f"knn_topk {rows}x{m}: {launches} launches for one call")
        if rows < nq:  # the whole query cloud was held in [kernels] above
            d_p, i_p = knn_topk_plain(q, ref, k)
            torch.cuda.synchronize()
            check_equal(f"knn_topk {rows}x{m}", i, i_p)
            check_equal(f"knn_topk {rows}x{m}", d.view(torch.int32),
                        d_p.view(torch.int32), "distance bits")
        ms = cuda_ms(lambda: knn_topk_cuda(q, ref, k), reps=20)
        ops = 8.0 * rows * m
        b_ms, b_by = bound_ms((rows + m) * 12 + rows * k * 8, ops)
        lib = ""
        if rows == 2500:
            lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q[0], ref[0]), k,
                                                largest=False), reps=5)
            dev_ms = device_ms(lambda: knn_topk_cuda(q, ref, k), "knn_topk")
            lib = (f", device time {dev_ms:.4f} ms, library (cdist+topk) "
                   f"{lib_ms:.4f} ms")
            record["patch_2500"] = dict(
                plan=dict(S=plan), ms=ms, device_ms=dev_ms, bound_ms=b_ms,
                bound_no_fma_ms=no_fma_ms(ops), library_ms=lib_ms)
        print(f"[kernels] knn_topk {rows}x{m} k={k}, plan S={plan}: indices "
              f"and distance bits identical, {launches} launch per call; "
              f"kernel {ms:.4f} ms{lib}, bound {b_ms:.4f} ms ({b_by}; no-FMA "
              f"{no_fma_ms(ops):.4f} ms)" + knn_neighbours(q, ref, k, d, i))


def fps_neighbours(n: int) -> list[tuple[int, int, int]]:
    """The plan (S, threads, PER) for n points and the launches that halve
    or double its S and its threads, each with the fewest points per thread
    that hold a rank's slice."""
    S0, t0, _ = fps_plan(n)
    plans = []
    for S in (S0 // 2, S0, 2 * S0):
        for t in (t0 // 2, t0, 2 * t0):
            per = next((p for p in PERS if t * p >= -(-n // max(S, 1))), None)
            if (S in FPS_CLUSTER_SIZES and 32 <= t <= FPS_MAX_THREADS
                    and per is not None):
                plans.append((S, t, per))
    return plans


def phase_fps_plans(ref: torch.Tensor, record: dict) -> None:
    """FPS at the registers' cap, 65,536 -> 512, and on three 30,000-point
    lattice clouds (tied maxima, within and across ranks), identical to the
    plain version; the streaming kernel at 70,000 and 120,000 -> 512 (and
    forced at 65,536), identical, one launch a call; then at 30,000 -> 512,
    8,192 -> 512, 512 -> 128 and 65,536 -> 512 the plan against its
    neighbours (``fps_neighbours``), each identical to the plan's, in us per
    iteration."""
    rng = np.random.default_rng(6)  # the phase's own, as above
    dev = ref.device
    big = torch.from_numpy(normalize_point_cloud(make_cloud(
        rng, 65536))[0])[None].to(dev)
    lattice = torch.from_numpy((np.round(rng.standard_normal(
        (3, M_POINTS, 3)) * 4) / 4).astype(np.float32)).to(dev)
    for name, xyz in (("65536->512", big), ("lattice B=3 30000->512",
                                             lattice)):
        B, n = xyz.shape[:2]
        start = torch.from_numpy(rng.integers(0, n, B).astype(np.int32)
                                 ).to(dev)
        got = fps_cuda(xyz, 512, start)
        want = fps_plain(xyz, 512, start)
        torch.cuda.synchronize()
        check_equal(f"fps {name}", got, want)
        ms = cuda_ms(lambda: fps_cuda(xyz, 512, start), reps=10)
        print(f"[kernels] fps {name}, plan (S, threads, PER) {fps_plan(n)}: "
              f"indices identical; kernel {ms:.4f} ms "
              f"({1e3 * ms / 512:.3f} us per iteration)")

    # past the registers' 65,536 points: the streaming kernel, and at
    # 65,536 the streaming kernel forced against the resident one
    record["stream"] = {}
    for n in (70000, N_POINTS, 65536):
        xyz = big if n == 65536 else torch.from_numpy(normalize_point_cloud(
            make_cloud(rng, n))[0])[None].to(dev)
        start = torch.from_numpy(rng.integers(0, n, 1).astype(np.int32)
                                 ).to(dev)
        plans = [fps_plan(n)] + ([(8, 1024, STREAM)] if n <= FPS_MAX_POINTS
                                 else [(4, 1024, STREAM), (8, 512, STREAM)])
        want = fps_plain(xyz, 512, start)
        times = {}
        for plan in plans:
            before = LAUNCH_COUNTS["fps"]
            got = fps_cuda(xyz, 512, start, plan=plan)
            torch.cuda.synchronize()
            if LAUNCH_COUNTS["fps"] != before + 1:
                fail(f"fps {n}->512 plan {plan}: not one launch")
            check_equal(f"fps {n}->512 plan {plan}", got, want)
            times[plan] = cuda_ms(lambda: fps_cuda(xyz, 512, start,
                                                   plan=plan), reps=5)
        b_ms, b_by = bound_ms(n * 12 + 4 + 512 * 4, 9.0 * 512 * n)
        if n > FPS_MAX_POINTS:
            record["stream"][f"{n}->512"] = dict(
                plan=list(plans[0]), ms=times[plans[0]], bound_ms=b_ms)
        print(f"[kernels] fps {n}->512, plan {fps_plan(n)}: indices "
              f"identical under every plan (PER {STREAM}: the streaming "
              f"kernel, distances in global scratch), one launch a call; ms "
              f"(us per iteration) by plan: " + ", ".join(
                  f"{p} {t:.4f} ({1e3 * t / 512:.3f})"
                  for p, t in times.items())
              + f"; bound {b_ms:.5f} ms ({b_by}; latency-bound)")

    start = torch.zeros(1, dtype=torch.int32, device=dev)
    small = index_points(ref, fps_cuda(ref, 512, start)).contiguous()
    for xyz, npoint in ((ref, 512), (ref[:, :8192].contiguous(), 512),
                        (small, 128), (big, 512)):
        n = xyz.shape[1]
        want = fps_cuda(xyz, npoint, start)
        times = {}
        for plan in fps_neighbours(n):
            check_equal(f"fps {n}->{npoint} plan {plan}",
                        fps_cuda(xyz, npoint, start, plan=plan), want)
            times[plan] = 1e3 * cuda_ms(lambda: fps_cuda(
                xyz, npoint, start, plan=plan), reps=10) / npoint
        best = min(times, key=times.get)
        by_s = {S: min((t for p, t in times.items() if p[0] == S),
                       default=None) for S in FPS_CLUSTER_SIZES}
        print(f"[kernels] fps {n}->{npoint}, plan {fps_plan(n)} "
              f"{times[fps_plan(n)]:.3f} us per iteration; vs neighbours "
              "(S/threads/PER): " + " ".join(
                  f"{S}/{t}/{p} {u:.3f}" for (S, t, p), u in times.items())
              + ("" if best == fps_plan(n) else f" ({best} faster)"))
        if n == M_POINTS:
            record["us_per_iteration_by_S"] = {
                S: t for S, t in by_s.items() if t is not None}


def grid_tables(query: torch.Tensor, ref: torch.Tensor) -> tuple:
    """The grid's own layout pass of query [1, N, 3] against ref [1, M, 3]
    at the sampler's grid: (its ref structure, its slot tables)."""
    fz = grid_knn._full_z_ok(ref.shape[1], GRID_SHAPE, SLOT_CAP)
    struct = grid_knn._build_struct(ref[0], GRID_SHAPE, skip_z_sort=fz)
    return struct, grid_knn._layout_slots(struct, query[0], GRID_SHAPE,
                                          GRID_TQ, SLOT_CAP)


def phase_grid_kernels(rng: np.random.Generator, query: torch.Tensor,
                       ref: torch.Tensor) -> dict:
    """The grid's slot-run kernels on the tables of its own layout pass,
    its interpolation after the fallback against brute force, and the
    ``knn(backend="grid")`` path."""
    records = {}
    nq, m = query.shape[1], ref.shape[1]
    vals = torch.from_numpy(
        rng.standard_normal((m, 3)).astype(np.float32)).to(ref.device)
    struct, sl = grid_tables(query, ref)
    q_pad, refs_pad, st, en = sl.q_pad, struct.refs_pad, sl.st, sl.en
    n_real = sl.n_real
    vals_pad = grid_knn._sorted_values(struct, vals)
    T, S = st.shape
    runs = (en - st).clamp(min=0).sum(1)  # candidates per tile
    # the pairs this data needs: each real query against its tile's runs;
    # the kernel scans whole warps that hold a real row, the parent's
    # kernel every row of every tile
    pairs = int((n_real * runs).sum())
    warp_rows = (-(-n_real // 32) * 32).clamp(max=GRID_TQ)
    scanned = int((warp_rows * runs).sum())
    scanned_all = GRID_TQ * int(runs.sum())
    shape = (f"{nq} queries in {T} tiles of {GRID_TQ} ({int(n_real.sum())} "
             f"real rows, {int((n_real == 0).sum())} empty tiles), {S} slots, "
             f"{m} refs, k=3")
    print(f"[kernels] grid tables {GRID_SHAPE}/{SLOT_CAP}: {shape}; "
          f"candidates per tile mean {runs.float().mean():.1f}, max "
          f"{int(runs.max())}; pairs needed {pairs}, scanned {scanned} "
          f"(warps with a real row), {scanned_all} without n_real (brute "
          f"force: {nq * m})")

    def check_grid(name: str, refs_pad: torch.Tensor, n_real=None
                   ) -> tuple[float, torch.Tensor, torch.Tensor]:
        """Both kernels against the plain versions: distances and positions
        identical on every row, values within rtol 1e-6, atol 1e-6 *
        max|v| on rows with 3 candidates; returns (max |v| err, d, i)."""
        v_k, d_k = grid_interp_cuda(q_pad, refs_pad, vals_pad, st, en, 3,
                                    n_real=n_real)
        v_p, d_p = grid_interp_plain(q_pad, refs_pad, vals_pad, st, en, 3,
                                     n_real=n_real)
        d_t, i_t = grid_topk_cuda(q_pad, refs_pad, st, en, 3, n_real=n_real)
        d_tp, i_tp = grid_topk_plain(q_pad, refs_pad, st, en, 3,
                                     n_real=n_real)
        torch.cuda.synchronize()
        for what, got, want in (("grid_interp", d_k, d_p),
                                ("grid_topk", d_t, d_tp)):
            check_equal(f"{what} {name}", got.view(torch.int32),
                        want.view(torch.int32), "distance bits")
        check_equal(f"grid_topk {name}", i_t, i_tp, "positions")
        full = d_p[:, -1] < 1e29
        err = values_err(v_k[full], v_p[full])
        if not np.isfinite(err) or not torch.isfinite(v_k).all():
            fail(f"grid_interp {name}: values differ from the plain version "
                 "beyond rtol 1e-6, atol 1e-6 * max|v| (or are not finite)")
        return err, d_t, i_t

    v_err, d_t, _ = check_grid("with n_real", refs_pad, n_real)
    check_grid("without n_real", refs_pad)
    full = d_t[:, -1] < 1e29
    # a NaN ref of each sign inside the first run of every 7th tile, set
    # on the host (a -nan scalar written on the card loses its sign bit)
    first = torch.unique(st[::7, 0][en[::7, 0] > st[::7, 0] + 1].long() + 1)
    host = refs_pad.cpu().numpy().copy()
    host[first[0::2].cpu().numpy(), 0] = -np.nan
    host[first[1::2].cpu().numpy(), 1] = np.nan
    nan_refs = torch.from_numpy(host).to(refs_pad.device)
    if not torch.signbit(nan_refs[first[0], 0]):
        fail("the grid's NaN check lost the sign bit of its -nan refs")
    _, d_n, i_n = check_grid("with NaN refs of both signs", nan_refs, n_real)
    if torch.isin(i_n[d_n < 1e29], first.int()).any():
        fail("grid_topk took a NaN ref")
    print(f"[kernels] grid kernels: distance bits and positions identical to "
          f"the plain versions on all {len(full)} rows with and without "
          f"n_real and with {len(first)} NaN refs of both signs (never "
          f"taken); max |v| err {v_err:.3g} on the {int(full.sum())} rows "
          "with 3 candidates")

    in_bytes = (q_pad.numel() + refs_pad.numel() + st.numel() + en.numel()
                + n_real.numel()) * 4
    for name, fn, plain, out_bytes, err in (
            ("grid_interp",
             lambda **kw: grid_interp_cuda(q_pad, refs_pad, vals_pad, st, en,
                                           3, **kw),
             lambda: grid_interp_plain(q_pad, refs_pad, vals_pad, st, en, 3,
                                       n_real=n_real),
             vals_pad.numel() * 4 + q_pad.shape[0] * (vals.shape[1] + 3) * 4,
             v_err),
            ("grid_topk",
             lambda **kw: grid_topk_cuda(q_pad, refs_pad, st, en, 3, **kw),
             lambda: grid_topk_plain(q_pad, refs_pad, st, en, 3,
                                     n_real=n_real),
             q_pad.shape[0] * 3 * 8, 0.0)):
        ms = device_ms(lambda: fn(n_real=n_real), name)
        ms_all = device_ms(lambda: fn(), name)
        call_ms = cuda_ms(lambda: fn(n_real=n_real), reps=50)
        plain_ms = cuda_ms(plain, reps=2)
        b_ms, b_by = bound_ms(in_bytes + out_bytes, 8.0 * pairs)
        nf_ms = no_fma_ms(8.0 * pairs)
        records[name] = dict(
            name=name, route="cuda",
            source="pointcloud_style_transfer_torch/csrc/grid_fused.cu",
            replaces="pointcloud_style_transfer_tpu/ops/pallas/grid_fused.py:"
                     + ("127" if name == "grid_interp" else "53"),
            shape=shape, max_abs_err=err,
            ms=ms, ms_without_n_real=ms_all, ms_per_call=call_ms,
            plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, bound_no_fma_ms=nf_ms,
            pairs_needed=pairs, pairs_scanned=scanned, library_ms=None)
        print(f"[kernels] {name}: kernel {ms:.4f} ms device time with "
              f"n_real (the main path's call), {ms_all:.4f} ms without; "
              f"{call_ms:.4f} ms per back-to-back call (events); plain "
              f"{plain_ms:.3f} ms; bound {b_ms:.5f} ms ({b_by}, {pairs} "
              f"pairs), no-FMA "
              f"{nf_ms:.5f} ms, half of it reached: "
              f"{'yes' if ms <= 2 * nf_ms else 'no'} ({100 * nf_ms / ms:.0f}%)"
              f"; library: none (no PyTorch call computes a kNN over slot "
              f"runs)")

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

PACKED = {
    # LAUNCH_COUNTS key: (kernel, plain, TPU wrapper's ref tile, key
    # resolution, line of the TPU kernel)
    "knn_f32packed": (knn_f32packed_keys_cuda, knn_f32packed_keys_plain, 4096,
                      2.0 ** -8, 476),
    "knn_packed": (knn_intpacked_keys_cuda, knn_intpacked_keys_plain, 2048,
                   2.0 ** -7, 103),
}


def phase_packed_kernels(query: torch.Tensor, ref: torch.Tensor,
                         exact_record: dict) -> dict:
    """The packed-key kNN kernels at the sampler's 90,000 x 30,000, k = 3
    (the clouds carry 1% exact duplicates and 500 queries on refs) and on a
    2,500-row patch, the grid fallback's size (its refs padded to the
    grid's 2,048 tile): raw keys identical to the plain version, hence the
    decoded indices and recomputed distances; every departure from the
    exact kernel a near-tie within the key's resolution; device time (the
    patch is shorter than its wrapper's host time), events beside it."""
    records = {}
    nq, m = query.shape[1], ref.shape[1]
    d_e, i_e = knn_topk_cuda(query, ref, 3)
    patch = query[:, :2500].contiguous()
    n_patch = patch.shape[1]
    for name, (kernel, plain, tr, res, line) in PACKED.items():
        m_total = knn_packed.padded_refs(m, tr)
        m_patch = knn_packed.padded_refs(m, 2048)
        idx_bits = 15 if name == "knn_f32packed" \
            else knn_packed.packed_idx_bits(m_total)
        for q, m_t in ((query, m_total), (patch, m_patch)):
            keys = kernel(q, ref, 3, m_t)
            keys_p = plain(q, ref, 3, m_t)
            torch.cuda.synchronize()
            check_equal(f"{name} {q.shape[1]}x{m}", keys.view(torch.int32),
                        keys_p.view(torch.int32), "raw keys")
            bits = 15 if name == "knn_f32packed" \
                else knn_packed.packed_idx_bits(m_t)
            d, i = knn_packed.decode_keys(q, ref, keys.view(torch.int32), bits)
            d_p, i_p = knn_packed.decode_keys(q, ref, keys_p.view(torch.int32),
                                              bits)
            check_equal(f"{name} {q.shape[1]}x{m}", i, i_p)
            check_equal(f"{name} {q.shape[1]}x{m}", d.view(torch.int32),
                        d_p.view(torch.int32), "recomputed distances")
        keys = kernel(query, ref, 3, m_total)
        d, i = knn_packed.decode_keys(query, ref, keys.view(torch.int32),
                                      idx_bits)
        # the t-th packed distance lies in the t-th exact one's key bucket
        if not ((d >= d_e) & (d <= d_e * (1 + res) + 1e-37)).all():
            fail(f"{name}: a selected neighbour is farther than the key's "
                 f"resolution {res} allows")
        differ = (torch.sort(i, dim=2).values
                  != torch.sort(i_e, dim=2).values).any(dim=2)
        farther = (d != d_e).any(dim=2)
        trace_name = f"{name}_kernel"
        ms = device_ms(lambda: kernel(query, ref, 3, m_total), trace_name)
        patch_ms = device_ms(lambda: kernel(patch, ref, 3, m_patch),
                             trace_name)
        ev_ms = cuda_ms(lambda: kernel(query, ref, 3, m_total), reps=20)
        ev_patch = cuda_ms(lambda: kernel(patch, ref, 3, m_patch), reps=20)
        decode_ms = cuda_ms(lambda: knn_packed.decode_keys(
            query, ref, keys.view(torch.int32), idx_bits), reps=10)
        plain_ms = cuda_ms(lambda: plain(query, ref, 3, m_total), reps=2)
        b_ms, b_by = bound_ms((nq + m) * 12 + nq * 3 * 4, 8.0 * nq * m)
        nf_ms = no_fma_ms(8.0 * nq * m)
        nf_patch = no_fma_ms(8.0 * n_patch * m)
        plan = dict(S=knn_topk_plan(1, nq, m),
                    S_patch=knn_topk_plan(1, n_patch, m))
        records[name] = dict(
            name=name, route="cuda",
            source="pointcloud_style_transfer_torch/csrc/knn_packed.cu",
            replaces="pointcloud_style_transfer_tpu/ops/pallas/"
                     f"distance_topk.py:{line}",
            shape=f"{nq}x{m} k=3", plan=plan, max_abs_err=0.0, ms=ms,
            events_ms=ev_ms, patch_ms=patch_ms, patch_events_ms=ev_patch,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_no_fma_ms=nf_ms, patch_bound_no_fma_ms=nf_patch,
            library_ms=exact_record["library_ms"])
        plan_txt = f"plan S={plan['S']} (patch S={plan['S_patch']}); "
        print(f"[kernels] {name} {nq}x{m} k=3 (padded to {m_total}; patch "
              f"{m_patch}): raw keys, indices and recomputed distances "
              f"identical at {nq} and {n_patch} rows; neighbour set differs "
              f"from knn_topk's on {int(differ.sum())} rows "
              f"({100 * differ.float().mean():.3f}%), {int(farther.sum())} of "
              f"them with a farther set, each within {res} relative; "
              f"{plan_txt}device {ms:.4f} ms ({100 * nf_ms / ms:.1f}% of the "
              f"no-FMA bound; events {ev_ms:.4f}; knn_topk events "
              f"{exact_record['ms']:.4f} ms), {n_patch}-row patch device "
              f"{patch_ms:.4f} ms ({100 * nf_patch / patch_ms:.1f}% of its "
              f"no-FMA bound {nf_patch:.4f}; events {ev_patch:.4f}), decode + "
              f"recompute + sort {decode_ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"library (cdist+topk) {exact_record['library_ms']:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; no-FMA {nf_ms:.4f} ms)")

    # row 8's entry point, its own path: counts read around it
    reset_launch_counts()
    d, i = brute_knn(query, ref, 3, exact=False)
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    if counts != expect_counts(knn_packed=1):
        fail(f"brute_knn(exact=False) launches {counts}")
    records["knn_packed"]["launches"] = counts["knn_packed"]
    records["knn_packed"]["path"] = "brute_knn(exact=False)"
    print(f"[kernels] brute_knn(exact=False) {nq}x{m}: launches {counts}")
    return records


def box_test_pairs(qs: torch.Tensor, rs: torch.Tensor, skip: torch.Tensor,
                   kth_start: torch.Tensor, kth_end: torch.Tensor, tq: int,
                   tr: int, n_real: int, m_real: int) -> tuple:
    """A pass's real pairs in the (32-query warp, staging chunk) blocks
    it visits, and of them those in blocks whose box some query of the warp
    is nearer than its k-th distance at the pass's start (the most the
    kernel's box test leaves it to scan) and at its end (the least)."""
    C = PRUNED_CHUNK
    nc = rs.shape[0] // C
    chunks = rs.view(nc, C, 3)
    lo, hi = chunks.amin(1), chunks.amax(1)
    g = torch.maximum(torch.maximum(lo[None] - qs[:, None], qs[:, None]
                                    - hi[None]), torch.zeros_like(lo[None]))
    lb = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    rows = torch.arange(qs.shape[0], device=qs.device)
    real_q = (rows < n_real).view(-1, 32).sum(1)
    real_r = (torch.arange(nc * C, device=qs.device) < m_real).view(nc, C
                                                                    ).sum(1)
    pairs = real_q[:, None] * real_r[None, :]
    visit = (skip == 0).repeat_interleave(tr // C, 1).repeat_interleave(
        tq // 32, 0)
    counts = [int((pairs * visit).sum())]
    for kth in (kth_start, kth_end):
        near = (lb < kth[:, None]).view(-1, 32, nc).any(1)
        counts.append(int((pairs * (visit & near)).sum()))
    return tuple(counts)


def phase_pruned_kernel(query: torch.Tensor, ref: torch.Tensor,
                        exact_record: dict) -> dict:
    """The pruned kNN at 90,000 x 30,000, k = 3, default tiles: both passes
    of the kernel against the plain version, then the whole call against the
    brute-force kernel; each pass in device time, events beside it, the
    unskipped ref tiles a query tile in each pass, and the pairs the warps'
    chunk box test leaves to scan. The bound counts the pairs the function
    visits: every real pair of the tiles the skip matrices leave, as the TPU
    kernel and the plain version scan them. Beside it, and apart from it,
    the pairs the box test leaves at the passes' final k-th distances, and
    the no-FMA time they would take."""
    k, tq, tr = 3, 512, 2048
    nq_pts, m = query.shape[1], ref.shape[1]
    q, r = query[0], ref[0]
    qs, rs, _, _ = pruned_knn.sort_and_pad(q, r, tq, tr)
    nq, nr = qs.shape[0] // tq, rs.shape[0] // tr
    in_window = pruned_knn.window_mask(nq, nr, 2, q.device)
    skip1 = (~in_window).int().contiguous()
    d0 = qs.new_full((qs.shape[0], k), 1e30)
    i0 = torch.zeros((qs.shape[0], k), dtype=torch.int32, device=q.device)
    d1, i1 = knn_pruned_pass_cuda(qs, rs, skip1, d0, i0, k, tq, tr)
    d1_p, i1_p = knn_pruned_pass_plain(qs, rs, skip1, d0, i0, k, tq, tr)
    skip2 = (pruned_knn.prune_mask(qs, rs, d1, k, tq, tr)
             | in_window).int().contiguous()
    d2, i2 = knn_pruned_pass_cuda(qs, rs, skip2, d1, i1, k, tq, tr)
    d2_p, i2_p = knn_pruned_pass_plain(qs, rs, skip2, d1, i1, k, tq, tr)
    torch.cuda.synchronize()
    for what, got, want in (("pass 1 distances", d1, d1_p),
                            ("pass 1 positions", i1, i1_p),
                            ("pass 2 distances", d2, d2_p),
                            ("pass 2 positions", i2, i2_p)):
        check_equal("knn_pruned", got, want, what)

    reset_launch_counts()
    d, i = knn(query, ref, k, backend="pallas_pruned")
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    if counts != expect_counts(knn_pruned=2):
        fail(f"knn(backend='pallas_pruned') launches {counts}")
    d_e, i_e = knn_topk_cuda(query, ref, k)
    check_equal("knn(backend='pallas_pruned') vs knn_topk", d, d_e,
                "distances")
    d4, _ = knn_topk_cuda(query, ref, k + 1)
    distinct = (d4[..., 1:] != d4[..., :-1]).all(-1)
    check_equal("knn(backend='pallas_pruned') vs knn_topk, distinct rows",
                i[distinct], i_e[distinct])

    tiles1, tiles2 = int((skip1 == 0).sum()), int((skip2 == 0).sum())
    pruned = int(((skip2 != 0) & ~in_window).sum())
    # the pairs this data needs: real queries x real refs of every tile pair
    # a pass visits (the kernel also scans the tiles' padding)
    real_q = (nq_pts - torch.arange(nq, device=q.device) * tq).clamp(0, tq)
    real_r = (m - torch.arange(nr, device=q.device) * tr).clamp(0, tr)
    visits = (skip1 == 0).long() + (skip2 == 0).long()
    pairs = int((visits * real_q[:, None] * real_r[None, :]).sum())
    if tq % 32 or tr % PRUNED_CHUNK:
        fail(f"knn_pruned: tiles {tq}x{tr} do not hold whole warps and chunks")
    boxed = [box_test_pairs(qs, rs, sk, k0, k1, tq, tr, nq_pts, m)
             for sk, k0, k1 in ((skip1, d0[:, -1], d1[:, -1]),
                                (skip2, d1[:, -1], d2[:, -1]))]
    needed = boxed[0][2] + boxed[1][2]
    passes = ((skip1, d0, i0), (skip2, d1, i1))
    ms1, ms2 = (device_ms(lambda: knn_pruned_pass_cuda(
        qs, rs, sk, di, ii, k, tq, tr), "knn_pruned_pass_kernel")
        for sk, di, ii in passes)
    ev1, ev2 = (cuda_ms(lambda: knn_pruned_pass_cuda(
        qs, rs, sk, di, ii, k, tq, tr), reps=20) for sk, di, ii in passes)
    spread = [(int(n.min()), float(n.float().mean()), int(n.max()))
              for n in ((skip1 == 0).sum(1), (skip2 == 0).sum(1))]
    call_ms = cuda_ms(lambda: knn(query, ref, k, backend="pallas_pruned"),
                      reps=10)
    plain_ms = cuda_ms(lambda: (
        knn_pruned_pass_plain(qs, rs, skip1, d0, i0, k, tq, tr),
        knn_pruned_pass_plain(qs, rs, skip2, d1, i1, k, tq, tr)), reps=1)
    # per launch: queries, refs, skip, state in; state out
    launch_bytes = (qs.numel() + rs.numel() + skip1.numel()) * 4 \
        + 4 * d0.numel() * 4
    b_ms, b_by = bound_ms(2 * launch_bytes, 8.0 * pairs)
    nf_ms = no_fma_ms(8.0 * pairs)
    nfn_ms = no_fma_ms(8.0 * needed)
    print(f"[kernels] knn_pruned {nq_pts}x{m} k={k}, tiles {tq}x{tr} "
          f"({nq}x{nr} tile pairs), S={PRUNED_S}: "
          "unskipped tiles a query "
          f"tile (least/mean/largest) pass 1 {spread[0][0]}/"
          f"{spread[0][1]:.2f}/{spread[0][2]}, pass 2 {spread[1][0]}/"
          f"{spread[1][1]:.2f}/{spread[1][2]}; pairs the (warp, chunk) box "
          f"test leaves to scan, of those visited: pass 1 {boxed[0][2]}-"
          f"{boxed[0][1]} of {boxed[0][0]}, pass 2 {boxed[1][2]}-"
          f"{boxed[1][1]} of {boxed[1][0]}; launches device {ms1:.4f} + "
          f"{ms2:.4f} ms ({100 * nf_ms / (ms1 + ms2):.1f}% of the no-FMA "
          f"bound on the pairs visited, {100 * nfn_ms / (ms1 + ms2):.1f}% of "
          f"that on the pairs the box test leaves; events {ev1:.4f} + "
          f"{ev2:.4f})")
    print(f"[kernels] knn_pruned {nq_pts}x{m} k={k}: both passes identical to "
          "the plain "
          f"version; result distances identical to knn_topk's, ids identical "
          f"on the {int(distinct.sum())} rows whose {k + 1} nearest distances "
          f"are distinct ({int((i != i_e).any(-1).sum())} rows differ in all)"
          f"; pass 1 visits {tiles1} tile pairs, pass 2 {tiles2} and skips "
          f"{pruned} of the other {nq * nr - tiles1} "
          f"({100 * pruned / (nq * nr - tiles1):.1f}%); {pairs} pairs in "
          f"the visited tiles ({100 * pairs / (nq_pts * m):.1f}% of brute "
          "force's); "
          f"whole call (sorts, boxes, masks, two launches, un-sort) "
          f"{call_ms:.4f} ms (knn_topk {exact_record['ms']:.4f} ms), plain "
          f"passes {plain_ms:.3f} ms, library (cdist+topk) "
          f"{exact_record['library_ms']:.3f} ms, bound for both launches "
          f"{b_ms:.4f} ms ({b_by}; no-FMA {nf_ms:.4f} ms) on the {pairs} "
          f"pairs visited; no-FMA {nfn_ms:.4f} ms on the {needed} the box "
          "test leaves")
    return dict(
        name="knn_pruned", route="cuda",
        source="pointcloud_style_transfer_torch/csrc/knn_pruned.cu",
        replaces="pointcloud_style_transfer_tpu/ops/pallas/pruned_knn.py:66",
        shape=f"{nq_pts}x{m} k={k}; ms, plain_ms and bound_ms are the mean "
              "of one call's two launches, library_ms is the whole call's",
        plan=dict(S=PRUNED_S),
        max_abs_err=0.0, ms=(ms1 + ms2) / 2,
        ms_passes=[ms1, ms2], events_ms_passes=[ev1, ev2],
        unskipped_tiles_passes=spread, plain_ms=plain_ms / 2,
        bound_ms=b_ms / 2, bound_by=b_by, bound_no_fma_ms=nf_ms / 2,
        pairs_visited=pairs, pairs_needed=needed,
        needed_no_fma_ms=nfn_ms / 2,
        box_test_pairs_passes=boxed, library_ms=exact_record["library_ms"])


def phase_grid_inexact(query: torch.Tensor, ref: torch.Tensor) -> None:
    """``grid_knn(exact=False)``: the grid pass, then the f32-packed kernel
    (never the exact one) on the rows it could not prove exact."""
    nq, m = query.shape[1], ref.shape[1]
    reset_launch_counts()
    grid_knn.UNSAFE_COUNTS.clear()
    d, i = grid_knn.grid_knn(query, ref, 3, exact=False)
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    n_unsafe = grid_knn.UNSAFE_COUNTS[-1]
    if counts != expect_counts(grid_topk=1, knn_f32packed=int(n_unsafe > 0)):
        fail(f"grid_knn(exact=False) launches {counts} with {n_unsafe} "
             "unsafe rows")
    d_e, i_e = grid_knn.grid_knn(query, ref, 3)
    if not ((d >= d_e) & (d <= d_e * (1 + 2.0 ** -8) + 1e-37)).all():
        fail("grid_knn(exact=False) departs from exact=True beyond the "
             "f32-packed key's resolution")
    print(f"[kernels] grid_knn(exact=False) {nq}x{m} k=3: launches {counts}, "
          f"{n_unsafe} unsafe rows through knn_f32packed; vs exact=True "
          f"{int((d != d_e).any(-1).sum())} rows with a farther set (each "
          f"within 2^-8 relative), {int((i != i_e).any(-1).sum())} rows with "
          "other ids")


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
        sl.q_pad, struct.refs_pad, vals_pad, sl.st, sl.en, 3,
        n_real=sl.n_real))
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
    points are the fewest that engage the default grid); the first case
    also step by step (``reference_trace``)."""
    for n, m, backend in ((4096, 1024, "pallas"), (24576, 6144, "auto")):
        reference_run(rng, dev, n, m, backend, trace=backend == "pallas")
    # a generator of its own: the phases that follow keep their clouds
    # whatever this run draws
    reference_run(np.random.default_rng(1), dev, 4096, 1024, "pallas",
                  fast=True)


def reference_run(rng: np.random.Generator, dev: torch.device, n: int,
                  m: int, backend: str, fast: bool = False,
                  trace: bool = False) -> None:
    """``fast``: the coarse displacement sampler instead of the per-step
    one; ``trace``: then ``reference_trace`` on the same inputs."""
    cfg = Config(total_points=n, global_points=m, use_amp=False,
                 knn_backend=backend)
    torch.manual_seed(1)
    net_cpu = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    net_gpu = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    net_gpu.load_state_dict(net_cpu.state_dict())
    src = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])[None]
    cond = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])[None]
    # x_init first: the draws' order fixes the clouds of every later phase
    x_init = torch.from_numpy(
        rng.standard_normal((1, m if fast else n, 3), np.float32))
    draws = dict(
        x_init=x_init,
        cond_priority=torch.from_numpy(rng.random((1, n), np.float32)),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64))
    if fast:
        sampler, what = guided_sample_loop_coarse, "coarse sampler, "
        draws["src_priority"] = torch.from_numpy(
            rng.random((1, n), np.float32))
        want = {"knn_topk": 1, "grid_interp": 0}
    else:
        sampler, what = guided_sample_loop, ""
        draws["step_priorities"] = torch.from_numpy(
            rng.random((STEPS, 1, n), np.float32))
        want = ({"grid_interp": STEPS} if backend == "auto"
                else {"grid_interp": 0, "knn_topk": STEPS})
    def run(device, net, selections=None):
        model = PointCloudDiffusionModel(cfg, device, net=net)
        kw = {} if selections is None else dict(selections=selections)
        return sampler(
            model, make_schedule(cfg), src, cond, num_inference_steps=STEPS,
            guidance_scale=GUIDANCE,
            **{k: v.to(model.device) for k, v in draws.items()}, **kw).cpu()

    # the per-step sampler's CPU run records its discrete choices
    cpu_sel = None if fast else {}
    outs = [run("cpu", net_cpu, cpu_sel)]
    reset_launch_counts()
    outs.append(run(dev, net_gpu))  # the card's own run
    counts = dict(LAUNCH_COUNTS)
    if any(counts[k] != v for k, v in want.items()):
        fail(f"reference ({backend}): launches {counts}, expected {want}")
    cd = chamfer_l2(outs[0][0], outs[1][0])
    max_abs = (outs[0] - outs[1]).abs().max().item()
    if not torch.isfinite(outs[1]).all():
        fail(f"reference ({what}{backend}): non-finite output")
    head = (f"[reference] {what}{n} points / {m} coarse, "
            f"knn_backend={backend!r}, {STEPS} steps, float32: ")
    if fast:  # its choices depend on the inputs alone: the own run is held
        if cd > 1e-3:
            fail(f"reference ({what}{backend}): card vs CPU Chamfer-L2 "
                 f"{cd:.3g} (> 1e-3)")
        print(f"{head}card (kernels, launches {counts}) vs CPU (plain) "
              f"Chamfer-L2 {cd:.3g}, max |d| {max_abs:.3g}")
    else:
        replayed = {k: v for k, v in cpu_sel.items()
                    if k.endswith((".voxel", ".knn"))}
        n_replayed = len(replayed)  # the run adds the card's points
        out = run(dev, net_gpu, replayed)
        cd_r = chamfer_l2(outs[0][0], out[0])
        if not torch.isfinite(out).all() or cd_r > 1e-3:
            fail(f"reference ({backend}): card, replaying the CPU's choices, "
                 f"vs CPU Chamfer-L2 {cd_r:.3g} (> 1e-3) or non-finite")
        # the card's own choices on the CPU's inputs of every step: any
        # that differs must be a near-tie, and few may
        flipped, n_choices, worst = sampler_choices(cpu_sel, cpu_sel, cfg,
                                                    draws, dev)
        total, limit = sum(flipped.values()), FLIP_SHARE * n_choices
        if worst > NEAR_TIE_ULPS or total > limit:
            fail(f"reference ({backend}): the card's own choices on the "
                 f"CPU's inputs depart from the CPU's: {flipped}, the CPU's "
                 f"largest margin among them {worst:.3g} ulps of its scale "
                 f"(limit {NEAR_TIE_ULPS}), {total} of {n_choices} (limit "
                 f"{limit:.0f})")
        # not held: on the replayed run's own trajectory
        drift, _, drift_worst = sampler_choices(cpu_sel, replayed, cfg,
                                                draws, dev)
        print(f"{head}card (kernels), the CPU's {n_replayed} choices "
              f"replayed, vs CPU (plain) Chamfer-L2 {cd_r:.3g}, max |d| "
              f"{(out - outs[0]).abs().max().item():.3g}; the card's own "
              f"choices on the CPU's inputs of each step: {total} of "
              f"{n_choices} differ ({flipped}; limit {limit:.0f}), the CPU's "
              f"largest margin among them {worst:.3g} ulps of its scale "
              f"(limit {NEAR_TIE_ULPS}); not held: on the replayed run's "
              f"trajectory {sum(drift.values())} of them differ (from step "
              f"{min((int(k.split('.')[0][4:]) for k in drift), default='-')}"
              f", the CPU's largest margin {drift_worst:.3g} ulps), and the "
              f"card's own run (launches {counts}) vs CPU Chamfer-L2 "
              f"{cd:.3g}, max |d| {max_abs:.3g}")
    if trace:
        reference_trace(cfg, (net_cpu, net_gpu), dev, src, cond, draws, outs)


def traced_steps(model: PointCloudDiffusionModel, src: torch.Tensor,
                 cond: torch.Tensor, draws: dict,
                 forced: dict | None = None) -> dict:
    """``guided_sample_loop``'s hierarchical branch with the draws passed
    in, stage by stage on the model's device, every stage's output of every
    step kept on the CPU: the encoder's discrete choices (the condition's
    voxel keep set, both FPS and both ball queries), then per step the time
    embedding, the voxel priority order, the noise predictor's output, the
    CFG combine, the upsample's neighbours and interpolation weights, the
    upsampled noise and the DDIM step. With ``forced`` (the CPU's records)
    each stage also runs on the CPU's own inputs of that stage, so that its
    difference to the CPU is the op's alone (``forced`` in the result)."""
    cfg, dev = model.config, model.device
    M, backend = cfg.global_points, samplers.resolve_sampler_knn_backend(cfg)
    schedule = make_schedule(cfg).to(dev)
    host = (lambda t: t.detach().cpu())  # noqa: E731
    on = (lambda t: t.to(dev))  # noqa: E731
    src, cond = on(src), on(cond)
    starts = on(draws["fps_starts"])
    cond_ds, cond_idx = voxel_downsample(cond, M,
                                         priority=on(draws["cond_priority"]))
    fps1 = farthest_point_sample(cond_ds, 512, start=starts[0])
    l1 = index_points(cond_ds, fps1)
    ball1 = query_ball_point(0.2, 32, cond_ds, l1)
    fps2 = farthest_point_sample(l1, 128, start=starts[1])
    ball2 = query_ball_point(0.4, 64, l1, index_points(l1, fps2))
    rec = {"encoder": {k: host(v) for k, v in dict(
        cond_keep=torch.sort(cond_idx, dim=1).values, fps1=fps1, ball1=ball1,
        fps2=fps2, ball2=ball2).items()}, "steps": [], "forced": []}
    style = model.encode_style(cond_ds, starts)
    style_in = torch.cat([style, torch.zeros_like(style)], dim=0)
    x = on(draws["x_init"])
    ts = ddim_timesteps(cfg.num_timesteps, STEPS)
    t_prev = np.where(ts > 0, np.concatenate([ts[1:], [-1]]), -1)

    def stages(s, x, style_in, cpu=None):
        """Step s's stages from state x; with ``cpu`` (the CPU's record of
        the step) each stage takes the CPU's output of the stages before."""
        t_in = torch.full((2,), int(ts[s]), dtype=torch.int64, device=dev)
        out = dict(x=x, temb=time_embedding(t_in, cfg.time_embed_dim))
        _, idx, unk, _ = voxel_downsample_partition(
            x, M, priority=on(draws["step_priorities"][s]))
        out["perm"] = torch.cat([idx, unk], dim=1)
        if cpu is not None:
            idx, unk = on(cpu["perm"][:, :M]), on(cpu["perm"][:, M:])
        xc, unk_xyz = index_points(x, idx), index_points(x, unk)
        out["noise"] = model.predict_noise(torch.cat([xc, xc]), t_in,
                                           style_in).float()
        if cpu is not None:  # and with the time embedding the CPU computes
            with cpu_time_embedding():
                out["noise_cpu_temb"] = model.predict_noise(
                    torch.cat([xc, xc]), t_in, style_in).float()
        nc, nu = (out["noise"] if cpu is None else on(cpu["noise"])).chunk(2)
        out["guided"] = nu + GUIDANCE * (nc - nu)
        sq_d, out["nbr"] = knn(unk_xyz, xc, 3, backend=backend)
        w = 1.0 / (torch.sqrt(torch.clamp(sq_d, min=0.0)) + 1e-8)
        out["w"] = w / torch.sum(w, dim=-1, keepdim=True)
        out["final"] = samplers._upsample_unknown(
            x, idx, out["guided"] if cpu is None else on(cpu["guided"]),
            backend, unknown=unk, ref_xyz=xc, unknown_xyz=unk_xyz)
        out["x_next"] = ddim_step(
            schedule, x, out["final"] if cpu is None else on(cpu["final"]),
            int(ts[s]), int(t_prev[s]), source_points=src,
            content_anchor=cfg.content_anchor, target_range=cfg.target_range)
        return out

    for s in range(STEPS):
        own = stages(s, x, style_in)
        rec["steps"].append({k: host(v) for k, v in own.items()})
        if forced is not None:
            c = forced["steps"][s]
            rec["forced"].append({k: host(v) for k, v in stages(
                s, on(c["x"]), on(forced["style_in"]), c).items()})
        x = own["x_next"]
    rec["style_in"] = host(style_in)
    rec["out"] = host(x)
    return rec


@contextlib.contextmanager
def cpu_time_embedding():
    """Within the block the noise predictor's time embedding is computed on
    the CPU and moved to the input's device."""
    orig = networks.time_embedding
    networks.time_embedding = (
        lambda t, dim: orig(t.cpu(), dim).to(t.device))  # noqa: E731
    try:
        yield
    finally:
        networks.time_embedding = orig


def library_versions() -> str:
    """torch, CUDA and cuBLAS versions and the float32 matmul settings."""
    cublas = "not read"
    try:  # the library torch has loaded
        lib = ctypes.CDLL(f"libcublas.so.{str(torch.version.cuda)[:2]}")
        val = ctypes.c_int()
        parts = []
        for prop in range(3):  # MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL
            if lib.cublasGetProperty(prop, ctypes.byref(val)) != 0:
                raise OSError("cublasGetProperty failed")
            parts.append(str(val.value))
        cublas = ".".join(parts)
    except OSError as e:
        cublas = f"not read ({e})"
    prec = getattr(torch.backends.cuda.matmul, "fp32_precision", "n/a")
    return (f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuBLAS "
            f"{cublas}, float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r} (cuda.matmul "
            f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"fp32_precision={prec!r}; cudnn allow_tf32="
            f"{torch.backends.cudnn.allow_tf32})")


def voxel_margin(x_cpu: torch.Tensor, x_card: torch.Tensor, M: int
                 ) -> tuple[int, float, bool]:
    """The points [N, 3] whose voxel differs between the CPU's state and the
    card's, each on its own voxel geometry: (how many, the largest CPU
    margin among them in ulps of the largest voxel coordinate: how far the
    CPU's coordinate lies from the boundary between the two voxels,
    whether the voxel sizes are identical)."""
    lo, vs = voxel_geometry(x_cpu, M)
    f = (x_cpu - lo) / vs
    lo_g, vs_g = voxel_geometry(x_card.to(x_cpu.device), M)
    moved = torch.floor(f) != torch.floor((x_card.to(x_cpu.device) - lo_g)
                                          / vs_g)
    margin = (f - torch.round(f)).abs()[moved]
    return (int(moved.any(1).sum()), ulps_of(margin, f.abs().max()),
            torch.equal(vs, vs_g))


def knn_margin(q: torch.Tensor, r: torch.Tensor, nbr_cpu: torch.Tensor,
               nbr_card: torch.Tensor) -> tuple[int, float]:
    """Rows [Nq] whose neighbour sets differ: (how many, the largest CPU
    margin among them, the CPU's squared distance [q [Nq, 3], r [M, 3]] of
    the card's farthest pick past its own k-th, in ulps of the largest
    squared coordinate)."""
    nbr_card = nbr_card.to(nbr_cpu.device)
    rows = (torch.sort(nbr_cpu, dim=1).values
            != torch.sort(nbr_card, dim=1).values).any(1)
    d = pairwise_sq_dist(q[rows], r)
    margin = (d.gather(1, nbr_card[rows].long()).amax(1)
              - d.gather(1, nbr_cpu[rows].long()).amax(1))
    scale = torch.maximum(q.abs().max(), r.abs().max()) ** 2
    return int(rows.sum()), ulps_of(margin, scale)


def sampler_choices(cpu: dict, points: dict, cfg: Config, draws: dict,
                    dev: torch.device) -> tuple[dict, int, float]:
    """The card's own choice at every step, made on the step's points in
    ``points`` (the CPU's, or a card run's: each choice's ``.points``,
    ``.query`` and ``.ref``), against the CPU's recorded one: ({choice:
    how many differ}, how many choices in all, the CPU's largest margin
    among the differing ones in ulps of its scale)."""
    M, n_choices, flipped, worst = cfg.global_points, 0, {}, 0.0
    backend = samplers.resolve_sampler_knn_backend(cfg)
    for s in range(STEPS):
        key = f"step{s}.voxel"
        own = voxel_order(points[f"{key}.points"].to(dev), M,
                          priority=draws["step_priorities"][s].to(dev))
        keep = torch.sort(cpu[key][0, :M]).values
        n = int((~torch.isin(keep, own[0, :M].to(keep.device))).sum())
        n_choices += own.shape[1]
        if n:
            _, ulps, _ = voxel_margin(cpu[f"{key}.points"][0],
                                      points[f"{key}.points"][0], M)
            flipped[key] = n
            worst = max(worst, ulps)
        key = f"step{s}.knn"
        q, r = points[f"{key}.query"].to(dev), points[f"{key}.ref"].to(dev)
        own = knn(q, r, cpu[key].shape[-1], backend=backend)[1]
        rows, ulps = knn_margin(cpu[f"{key}.query"][0], cpu[f"{key}.ref"][0],
                                cpu[key][0], own[0])
        n_choices += q.shape[1]
        if rows:
            flipped[key] = rows
            worst = max(worst, ulps)
    return flipped, n_choices, worst


def ulps_of(margin: torch.Tensor, scale: float) -> float:
    """The largest of ``margin`` in float32 ulps of ``scale``."""
    if margin.numel() == 0:
        return 0.0
    return float(margin.max()) / float(np.spacing(np.float32(float(scale))))


def reference_trace(cfg: Config, nets: tuple, dev: torch.device,
                    src: torch.Tensor, cond: torch.Tensor, draws: dict,
                    outs: list) -> None:
    """[reference trace]: one reference case step by step, the CPU and the
    card each on their own trajectory with the CPU's draws (``traced_steps``,
    which must give the CPU sampler's output bit for bit). It names the first
    step at which a discrete choice of the card differs from the CPU's (the
    encoder's keep set, FPS or ball query picks; a step's voxel keep set or
    the upsample's neighbours) with that choice's CPU margin in float32 ulps
    of its scale: for the keep set, the points whose voxel differs, by how
    far the CPU's voxel coordinate lies from the boundary between them
    (scale: the largest voxel coordinate); for the neighbours, the CPU's
    squared distance of the card's pick past its own k-th (scale: the
    largest squared coordinate). For every stage before that step, the
    largest card-vs-CPU difference on each device's own trajectory and
    with the stage run on the CPU's inputs (the op's own difference)."""
    recs = []
    for device, net in (("cpu", nets[0]), (dev, nets[1])):
        model = PointCloudDiffusionModel(cfg, device, net=net)
        recs.append(traced_steps(model, src, cond, draws,
                                 recs[0] if recs else None))
    cpu, card = recs
    if not torch.equal(cpu["out"], outs[0]):
        fail("reference trace: the traced steps do not give the CPU "
             "sampler's output")
    card_same = torch.equal(card["out"], outs[1])
    M = cfg.global_points
    first, what = None, ""
    enc = [k for k in cpu["encoder"]
           if not torch.equal(cpu["encoder"][k], card["encoder"][k])]
    if enc:
        first, what = "encoder", f"encoder choices {enc} differ"
    departures = 0
    for s, (c, g) in enumerate(zip(cpu["steps"], card["steps"])):
        keep_c = torch.sort(c["perm"][0, :M]).values
        keep_g = torch.sort(g["perm"][0, :M]).values
        n_keep = int((~torch.isin(keep_c, keep_g)).sum())
        if n_keep:
            departures += 1
            if first is None:
                moved, ulps, same = voxel_margin(c["x"][0], g["x"][0], M)
                first = s
                what = (f"voxel keep set, {n_keep} of {M} kept points "
                        f"differ; {moved} points change voxel, the CPU's "
                        f"margin at most {ulps:.1f} ulps of the largest voxel "
                        f"coordinate; voxel sizes "
                        f"{'identical' if same else 'differ'}")
            continue
        perm = c["perm"][0]
        rows, ulps = knn_margin(c["x"][0][perm[M:]], c["x"][0][perm[:M]],
                                c["nbr"][0], g["nbr"][0])
        if rows:
            departures += 1
            if first is None:
                first = s
                what = (f"upsample neighbours, {rows} of {perm.numel() - M} "
                        f"rows differ, the CPU's margin at most {ulps:.1f} "
                        "ulps of the largest squared coordinate")
    before = range(first if isinstance(first, int) else
                   (0 if first == "encoder" else STEPS))
    # the card's own choices on the CPU's inputs: a difference there is an
    # op's, not the trajectory's
    op_keep, op_nbr = (sum(not torch.equal(f[key], c[key]) for f, c in zip(
        card["forced"], cpu["steps"])) for key in ("perm", "nbr"))
    diffs = []
    for key, name in (("temb", "time_embedding"), ("noise", "noise predictor"),
                      ("guided", "CFG combine"),
                      ("w", "interpolation weights"), ("final", "upsample"),
                      ("x_next", "ddim_step")):
        own, forced = ([float((run[s][key] - cpu["steps"][s][key]).abs().max())
                        for s in before] or [0.0]
                       for run in (card["steps"], card["forced"]))
        diffs.append(f"{name} {max(own):.3g} / {max(forced):.3g}")
    temb_cpu = max([float((card["forced"][s]["noise_cpu_temb"]
                           - cpu["steps"][s]["noise"]).abs().max())
                    for s in before] or [0.0])
    diffs.append(f"noise predictor with the CPU's time embedding - / "
                 f"{temb_cpu:.3g}")
    where = (f"none in {STEPS} steps" if first is None else
             f"at the encoder: {what}" if first == "encoder" else
             f"at step {first} of {STEPS}: {what}")
    print(f"[reference trace] {src.shape[1]} points / {M} coarse, "
          f"knn_backend={cfg.knn_backend!r}, float32, the CPU's draws: "
          f"first discrete departure of the card {where}; departures in "
          f"{departures} of {STEPS} steps; on the CPU's inputs the card's "
          f"voxel order differs in {op_keep} steps, its neighbours in "
          f"{op_nbr}; before it, the largest |card - "
          f"CPU| by stage, on each device's own trajectory / with the stage "
          f"on the CPU's inputs: {', '.join(diffs)}; the traced steps give "
          f"the CPU sampler's output bit for bit and the card sampler's "
          f"{'bit for bit' if card_same else 'not bit for bit'}; "
          f"{library_versions()}")


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
        expected = expect_counts(knn_topk=patched, fps=2, ball_query=2,
                                 grid_interp=STEPS)
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

        # the other serving paths at the same width: each driven once with
        # the counts set to 0 just before and read just after (that run is
        # also its warm-up), then timed. The grid and the brute path are
        # timed first, with no other engine on the card yet, so that their
        # seconds per cloud compare with earlier readings of this script.
        def time_engine(name: str, eng: DiffusionInference) -> None:
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

        for name, backend, fast, want in (
                ("brute (pallas)", "pallas", False,
                 expect_counts(knn_topk=STEPS, fps=2, ball_query=2)),
                ("f32-packed (pallas_f32packed)", "pallas_f32packed", False,
                 expect_counts(knn_f32packed=STEPS, fps=2, ball_query=2)),
                ("pruned (pallas_pruned)", "pallas_pruned", False,
                 expect_counts(knn_pruned=2 * STEPS, fps=2, ball_query=2)),
                ("fast (--fast, auto)", "auto", True, None)):
            path = save_checkpoint(os.path.join(tmp, f"{backend}.pt"),
                                   cfg.replace(knn_backend=backend), params,
                                   stats)
            eng = DiffusionInference(path, seed=1, device=dev, fast=fast)
            reset_launch_counts()
            grid_knn.UNSAFE_COUNTS.clear()
            out = eng.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)
            torch.cuda.synchronize()
            got = dict(LAUNCH_COUNTS)
            if fast:  # one upsample: the grid pass and at most one patch
                unsafe = list(grid_knn.UNSAFE_COUNTS)
                want = expect_counts(grid_topk=1, fps=2, ball_query=2,
                                     knn_topk=int(unsafe[0] > 0))
                if len(unsafe) != 1:
                    fail(f"--fast ran {len(unsafe)} grid passes")
                print(f"[main] --fast: one upsample of {N_POINTS} points "
                      f"from {M_POINTS}, {unsafe[0]} unsafe rows")
            if got != want or out.shape != (N_POINTS, 3) \
                    or not np.isfinite(out).all():
                fail(f"{name}: launches {got} != {want}, or output "
                     f"{out.shape} not finite")
            print(f"[main] {name}: output {out.shape} finite; launches {got}")
            counts[name] = got
            if backend == "pallas":
                time_engine("grid (auto)", engine)
            time_engine(name, eng)
        fast_engine = eng
        counts["knn_f32packed"] = counts["f32-packed (pallas_f32packed)"][
            "knn_f32packed"]
        counts["knn_pruned"] = counts["pruned (pallas_pruned)"]["knn_pruned"]
        counts["grid_topk"] = counts["fast (--fast, auto)"]["grid_topk"]

        for what, eng, top in (("one cloud", engine, 20),
                               ("one --fast cloud", fast_engine, 12)):
            profile_cloud(what, eng, src, ref, top)
        phase_batch_and_ddim(np.random.default_rng(2), engine, ckpt, tmp, src,
                             ref_path, card)
    return counts


def profile_cloud(what: str, engine: DiffusionInference, src: np.ndarray,
                  ref: np.ndarray, top: int) -> None:
    """One cloud through ``engine`` under the profiler: wall, device busy
    share, launches, and the kernels that take most device time."""
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
    print(f"[profile] {what}: wall {wall * 1e3:.1f} ms (profiled), "
          f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), "
          f"{sum(r[2] for r in rows)} kernel launches, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key, ms, cnt in rows[:top]:
        print(f"[profile]   {ms:9.3f} ms  x{cnt:<5d} {key[:100]}")


def phase_batch_and_ddim(rng: np.random.Generator, engine: DiffusionInference,
                         ckpt: str, tmp: str, src: np.ndarray, ref_path: str,
                         card: str) -> None:
    """``--source_dir`` with 3 clouds at ``--batch_size 2`` (a ragged tail)
    through the CLI, and ``ddim_sample_loop`` for 5 steps, both at
    ``Config()`` width on the grid."""
    src_dir, out_dir = os.path.join(tmp, "srcs"), os.path.join(tmp, "outs")
    os.makedirs(src_dir)
    for i in range(3):
        np.save(os.path.join(src_dir, f"cloud_{i}.npy"),
                src if i == 0 else make_cloud(rng, N_POINTS, dup_frac=0.0))
    reset_launch_counts()
    grid_knn.UNSAFE_COUNTS.clear()
    t0 = time.perf_counter()
    rc = cli_main(["--checkpoint", ckpt, "--source_dir", src_dir,
                   "--reference", ref_path, "--output_dir", out_dir,
                   "--batch_size", "2", "--num_steps", str(STEPS),
                   "--guidance_scale", str(GUIDANCE), "--device", "cuda"])
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    got = dict(LAUNCH_COUNTS)
    unsafe = list(grid_knn.UNSAFE_COUNTS)
    # two batches of two clouds (the tail padded with its last pair): the
    # encoder's kernels take the batch at once, the grid runs cloud by cloud
    want = expect_counts(grid_interp=4 * STEPS, fps=4, ball_query=4,
                         knn_topk=sum(u > 0 for u in unsafe))
    names = sorted(os.listdir(out_dir)) if rc == 0 else []
    outs = [np.load(os.path.join(out_dir, f)) for f in names]
    if rc != 0 or got != want or len(unsafe) != 4 * STEPS or names != [
            f"cloud_{i}_transferred.npy" for i in range(3)] or not all(
            o.shape == (N_POINTS, 3) and np.isfinite(o).all() for o in outs):
        fail(f"--source_dir: rc {rc}, outputs {names}, launches {got} != "
             f"{want}")
    print(f"[main] --source_dir, 3 clouds at --batch_size 2: 3 outputs of "
          f"{outs[0].shape}, finite; launches {got}; {batch_s:.3f} s incl. "
          f"checkpoint load and file IO, {batch_s / 3:.4f} s per output cloud "
          f"({card})")

    cfg = engine.config
    cond = torch.from_numpy(normalize_point_cloud(np.load(ref_path))[0])[None]
    shape_like = torch.zeros((1, N_POINTS, 3))
    gen = torch.Generator(device=engine.device).manual_seed(3)
    times = []
    for _ in range(2):  # warm-up, then the counted and timed run
        reset_launch_counts()
        grid_knn.UNSAFE_COUNTS.clear()
        t0 = time.perf_counter()
        out = ddim_sample_loop(engine.model, make_schedule(cfg), shape_like,
                               cond, num_inference_steps=5, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = dict(LAUNCH_COUNTS)
    want = expect_counts(grid_interp=5, fps=10, ball_query=10, knn_topk=sum(
        u > 0 for u in grid_knn.UNSAFE_COUNTS))
    if got != want or tuple(out.shape) != (1, N_POINTS, 3) \
            or not torch.isfinite(out).all():
        fail(f"ddim_sample_loop: launches {got} != {want}, output "
             f"{tuple(out.shape)}")
    print(f"[main] ddim_sample_loop, 5 steps at {N_POINTS} points: output "
          f"{tuple(out.shape)} finite; launches {got}; {times[1]:.4f} s "
          f"(first run {times[0]:.4f} s) ({card})")


# each training mini-step's launches (the Chamfer's two k=1 kNN, the
# style encoder's FPS and ball query)
TRAIN_STEP_LAUNCHES = expect_counts(knn_topk=2, fps=2, ball_query=2)


def flat(tensors: dict) -> torch.Tensor:
    return torch.cat([v.detach().reshape(-1) for v in tensors.values()])


def phase_train(rng: np.random.Generator, dev: torch.device, card: str,
                work: str) -> dict:
    """The training path at ``Config()`` defaults through the CLIs a user
    calls; each mini-step is timed and its launches counted (set to 0 just
    before it, read just after). Returns the run's paths."""
    raw = os.path.join(work, "raw")
    for i in range(4):
        for side, cloud in zip(("sim", "real"), lidar_scene_pair(rng, N_POINTS)):
            os.makedirs(os.path.join(raw, side), exist_ok=True)
            np.save(os.path.join(raw, side, f"scene_{i}.npy"), cloud)
    processed = os.path.join(work, "processed")
    t0 = time.perf_counter()
    rc = preprocess_main(["--sim_dir", os.path.join(raw, "sim"),
                          "--real_dir", os.path.join(raw, "real"),
                          "--output_dir", processed,
                          "--total_points", str(N_POINTS),
                          "--global_points", str(M_POINTS),
                          "--device", "cuda"])
    pre_s = time.perf_counter() - t0
    split = {d: sorted(os.listdir(os.path.join(processed, d)))
             for d in ("train", "val")}
    if rc != 0 or [len(split["train"]), len(split["val"])] != [3, 1]:
        fail(f"preprocess CLI: rc {rc}, files {split}")
    print(f"[train] cli.preprocess: 4 synthetic {N_POINTS}-point scene pairs "
          f"-> 3 train, 1 val in {pre_s:.2f} s (host numpy)")

    steps, trainers = [], []
    orig = DiffusionTrainer.train_step

    def instrumented(self, sim, real, lr, draws=None):
        if self not in trainers:
            trainers.append(self)
        p0, e0 = flat(self.params), flat(self.ema_params)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = orig(self, sim, real, lr, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append(dict(
            ms=ms, counts=dict(LAUNCH_COUNTS), emit=out[1],
            terms={k: v.item() for k, v in out[0].items()},
            params=not torch.equal(p0, flat(self.params)),
            ema=not torch.equal(e0, flat(self.ema_params))))
        return out

    args = ["--experiment_name", "smoke", "--data_dir", processed,
            "--num_epochs", "2", "--val_interval", "1"]
    cwd = os.getcwd()
    DiffusionTrainer.train_step = instrumented
    os.chdir(work)  # the default checkpoint/log/result dirs are relative
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = train_main(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg = Config().replace(experiment_name="smoke",
                               processed_data_dir=processed, num_epochs=2,
                               val_interval=1)
        resumed = DiffusionTrainer(cfg, resume=True, device=dev)
    finally:
        DiffusionTrainer.train_step = orig
        os.chdir(cwd)
    if rc != 0 or len(trainers) != 1:
        fail(f"train CLI: rc {rc}, {len(trainers)} trainers")
    pattern = [False, False, True, False, False, True]
    for key in ("emit", "params", "ema"):
        got = [st[key] for st in steps]
        if got != pattern:
            fail(f"train: {key} per mini-step {got}, expected {pattern}")
    for i, st in enumerate(steps):
        if st["counts"] != TRAIN_STEP_LAUNCHES:
            fail(f"train: mini-step {i + 1} launches {st['counts']}, "
                 f"expected {TRAIN_STEP_LAUNCHES}")
        if not all(np.isfinite(v) for v in st["terms"].values()):
            fail(f"train: mini-step {i + 1} loss terms {st['terms']}")
    base = os.path.join(work, "checkpoints", "smoke")
    ckpts = sorted(os.listdir(base))
    if ckpts != ["best_model", "ckpt_epoch_0000", "ckpt_epoch_0001"]:
        fail(f"train: checkpoints {ckpts}")
    trained = trainers[0]
    same = (torch.equal(flat(resumed.params), flat(trained.params))
            and torch.equal(flat(resumed.ema_params), flat(trained.ema_params))
            and resumed.optimizer.state_dict()["count"] == 2)
    if resumed.start_epoch != 2 or not same:
        fail(f"resume: start epoch {resumed.start_epoch}, same state {same}")
    ms = [st["ms"] for st in steps]
    warm = ms[1:]
    print(f"[train] cli.train, Config() defaults ({cfg.total_points} points, "
          f"{cfg.global_points} coarse, feature_dim {cfg.feature_dim}, "
          f"{'bf16' if cfg.use_amp else 'float32'}, B={cfg.batch_size}, "
          f"accumulation {cfg.gradient_accumulation_steps}): 2 "
          f"epochs, 6 mini-steps, 2 optimizer steps, 2 validations, "
          f"checkpoints {ckpts}; {train_s:.2f} s in all; peak memory "
          f"{peak:.2f} GiB ({card})")
    print(f"[train] per mini-step: launches {TRAIN_STEP_LAUNCHES} each; "
          f"params/EMA moved after mini-steps "
          f"{[i + 1 for i, st in enumerate(steps) if st['params']]}; loss "
          f"terms {[{k: round(v, 5) for k, v in st['terms'].items()} for st in steps]}")
    print(f"[train] ms per mini-step (synchronised): "
          f"{', '.join(f'{t:.2f}' for t in ms)}; warm mean {np.mean(warm):.2f}"
          f" ms (non-emitting {np.mean([ms[i] for i in (1, 3, 4)]):.2f}, "
          f"emitting {np.mean([ms[i] for i in (2, 5)]):.2f}); per optimizer "
          f"step (mini-steps 4-6) {sum(ms[3:6]):.2f} ms")
    print(f"[train] resumed trainer: start epoch {resumed.start_epoch}, "
          "params, EMA and optimizer state identical")

    # one mini-step of the resumed trainer under the profiler
    batch = next(iter(create_dataloaders(cfg)[0]))
    sim = resumed._to_device(batch["sim_full"])
    real = resumed._to_device(batch["real_full"])
    resumed.train_step(sim, real, 1e-4)
    torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        resumed.train_step(sim, real, 1e-4)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] one training mini-step: wall {wall:.1f} ms (profiled), "
          f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
          f"{sum(r[2] for r in rows)} kernel launches")
    for key, t, cnt in rows[:12]:
        print(f"[profile]   {t:9.3f} ms  x{cnt:<5d} {key[:100]}")
    return {"best": os.path.join(base, "best_model"),
            "val": os.path.join(processed, "val", split["val"][0]),
            "processed": processed}


# the CPU tests' tolerances (tests/test_torch_train_step.py): of each
# tensor's largest |g|, by part of the network
GRAD_RTOL = {"noise_predictor.": 2e-5, "style_encoder.fc": 2e-4,
             "style_encoder.encoder.": 5e-2}
PRE_BN_BIAS_RATIO = 1e-3


def pre_bn_bias(name: str) -> bool:
    """A Dense bias that feeds a train-mode BatchNorm (it cancels there)."""
    return ".linears." in name and name.endswith(".bias")


# A choice of the card's own step that differs from the CPU's must be a
# near-tie: the CPU's margin for it (the |pre-activation| of a ReLU gate,
# the gap between the two pooled values, between the two squared
# distances) within NEAR_TIE_ULPS float32 ulps of the scale of what it was
# chosen from; and at most FLIP_SHARE of all the step's choices may differ.
# (On an H100 the three clouds' flips were 2-4 gates a step, at most 8.3
# ulps; the CPU tests' planted wrong argmin, argmax and gate are over 1e6
# ulps off: tests/test_torch_pinned_selections.py.)
NEAR_TIE_ULPS = 32
FLIP_SHARE = 1e-4


def selection_flips(cpu: dict, card: dict) -> dict:
    """For every choice recorded by a training step
    (``draws["selections"]``): (choices, how many of the card's differ from
    the CPU's, the largest CPU margin of those in ulps of the scale). Gates
    are judged on the CPU's pre-activation (scale: its largest |x|), the
    set abstractions' max-pool argmaxes (over dim 2) on the pooled values,
    the Chamfer's argmins on the squared distances of the CPU's points
    (scale: their largest squared coordinate)."""
    out = {}
    for key, a in cpu.items():
        if key.endswith((".query", ".ref")):
            continue
        b = card[key]
        if ".relu" in key:
            flip = (a > 0) != (b > 0).cpu()
            margin, scale = a.abs(), a.abs().max()
        elif key.endswith(".pool"):
            ia = a.max(dim=2, keepdim=True).indices
            ib = b.max(dim=2, keepdim=True).indices.cpu()
            flip = (ia != ib)[:, :, 0]
            margin = (a.gather(2, ia) - a.gather(2, ib))[:, :, 0]
            scale = a.abs().max()
        else:  # a Chamfer argmin
            q, r = cpu[f"{key}.query"], cpu[f"{key}.ref"]
            ib = b.cpu()
            flip = a != ib

            def sq(idx):
                d = q - index_points(r, idx)
                return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                        + d[..., 2] * d[..., 2])
            margin = sq(ib) - sq(a)
            scale = torch.maximum(q.abs().max(), r.abs().max()) ** 2
        ulps = margin[flip] / float(np.spacing(np.float32(scale.item())))
        out[key] = (flip.numel(), int(flip.sum()),
                    float(ulps.max()) if flip.any() else 0.0)
    return out


# the train reference's clouds and draws: generators of its own, three of
# them, so that its verdict shows it depends on no particular draw
TRAIN_REFERENCE_SEEDS = (8, 9, 10)


def phase_train_reference(dev: torch.device) -> None:
    for seed in TRAIN_REFERENCE_SEEDS:
        train_reference(dev, seed)


def train_reference(dev: torch.device, seed: int) -> None:
    """One float32 training mini-step's loss and gradients on the card
    (kernels) and on the CPU (plain versions) with the same weights and
    draws, at 4,096 points / 1,024 coarse and full width, the clouds and
    draws from ``seed``. The CPU step records its discrete selections (ReLU
    gates, max-pool argmaxes, Chamfer argmins; ``draws["selections"]``) and
    the card's step replays them, so the two differ by continuous rounding
    only and are held to the CPU tests' bars by part. A card step with its
    own selections is held on them (``selection_flips``): each that
    differs from the CPU's a near-tie, at most ``FLIP_SHARE`` of them; its
    gradients are printed, not held."""
    rng = np.random.default_rng(seed)
    n, m = 4096, 1024
    cfg = Config(total_points=n, global_points=m, use_amp=False)
    torch.manual_seed(2)
    net_cpu = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    net_gpu = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    net_gpu.load_state_dict(net_cpu.state_dict())
    sim = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])[None]
    real = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n))[0])[None]
    draws = dict(
        t=torch.tensor([500]),
        noise=torch.from_numpy(rng.standard_normal((1, n, 3), np.float32)),
        cond_priority=torch.from_numpy(rng.random((1, n), np.float32)),
        noisy_priority=torch.from_numpy(rng.random((1, n), np.float32)),
        fps_starts=torch.zeros((2, 1), dtype=torch.int64),
        drop_u=torch.tensor([[0.5]]),
        style_dropout_mask=torch.from_numpy(rng.random((1, 512)) < 0.9))
    masks = [torch.from_numpy(rng.random((1, m, cfg.feature_dim)) < 0.9)
             for _ in range(6)]

    def step(device, net, selections):
        model = PointCloudDiffusionModel(cfg, device, net=net)
        d = {k: v.to(model.device) for k, v in draws.items()}
        d["noise_dropout_masks"] = [mk.to(model.device) for mk in masks]
        d["selections"] = selections
        reset_launch_counts()
        loss, terms = compute_losses(
            model, make_schedule(cfg).to(model.device),
            sim.to(model.device), real.to(model.device), train=True,
            cond_drop_prob=cfg.cond_drop_prob,
            chamfer_weight=cfg.lambda_chamfer, draws=d)
        params = dict(model.net.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        return ({k: v.item() for k, v in terms.items()},
                {k: g.cpu() for k, g in zip(params, grads)},
                dict(LAUNCH_COUNTS))

    pinned = {}
    t_c, g_c, _ = step("cpu", net_cpu, pinned)  # records
    own = {}
    t_o, g_o, counts_o = step(dev, net_gpu, own)  # the card's own choices
    t_g, g_g, counts = step(dev, net_gpu, pinned)  # replays the CPU's
    choices = selection_flips(pinned, own)
    entries = sum(c[0] for c in choices.values())
    flips = {k: c[1] for k, c in choices.items() if c[1]}
    worst_tie = max(c[2] for c in choices.values())

    def errors(t, g):
        loss_err = max(abs(t[k] - t_c[k]) / abs(t_c[k]) for k in t_c)
        worst = {}
        for name in g_c:
            if pre_bn_bias(name):  # zero in exact arithmetic: rounding noise
                weight = name[:-len("bias")] + "weight"
                ratio = (max(g_c[name].abs().max(), g[name].abs().max())
                         / g_c[weight].abs().max()).item()
                part = "pre-BN bias"
            else:
                ratio = ((g[name] - g_c[name]).abs().max()
                         / g_c[name].abs().max()).item()
                part = next(p for p in GRAD_RTOL if name.startswith(p))
            worst[part] = max(worst.get(part, 0.0), ratio)
        return loss_err, worst

    loss_err, worst = errors(t_g, g_g)
    loss_own, worst_own = errors(t_o, g_o)
    limits = {part: GRAD_RTOL.get(part, PRE_BN_BIAS_RATIO) for part in worst}
    print(f"[train reference] seed {seed}: float32 mini-step at {n} points /"
          f" {m} coarse, same weights and draws: card (launches {counts}) vs "
          f"CPU, the CPU's {len(choices)} selections replayed: loss terms max "
          f"rel err {loss_err:.3g}; worst gradient err / max |g| by part (limit): "
          + ", ".join(f"{k} {worst[k]:.3g} ({limits[k]:.3g})" for k in worst))
    print(f"[train reference] seed {seed}: the card's own selections: "
          f"{sum(flips.values())} of {entries} differ from the CPU's "
          f"({flips}; limit {FLIP_SHARE * entries:.0f}), the CPU's largest "
          f"margin among them {worst_tie:.3g} ulps of its scale (limit "
          f"{NEAR_TIE_ULPS}); not held: loss terms max rel err "
          f"{loss_own:.3g}; worst gradient err / max |g|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst_own.items()))
    if counts != TRAIN_STEP_LAUNCHES or counts_o != TRAIN_STEP_LAUNCHES:
        fail(f"train reference seed {seed}: card launches {counts}, "
             f"{counts_o}")
    if worst_tie > NEAR_TIE_ULPS or sum(flips.values()) > FLIP_SHARE * entries:
        fail(f"train reference seed {seed}: the card's own selections "
             f"differ from the CPU's in {flips}, the largest CPU margin "
             f"{worst_tie:.3g} ulps: not near-ties")
    bad = [k for k in worst if not worst[k] <= limits[k]]
    if loss_err > 1e-5 or bad:
        fail(f"train reference seed {seed}: loss terms {t_g} vs CPU {t_c}; "
             f"gradients beyond tolerance in {bad}")


def phase_eval(dev: torch.device, card: str, work: str,
               paths: dict) -> int:
    """``cli.inference`` from the trained ``best_model`` directory, then
    ``cli.compare --json`` of its output against the val pair's reference
    and the metrics suite. Returns the compare call's row-min launches."""
    with np.load(paths["val"]) as z:
        src, ref = z["sim_full"], z["real_full"]
    src_path, ref_path, out_path = (os.path.join(work, f) for f in
                                    ("eval_src.npy", "eval_ref.npy",
                                     "eval_out.npy"))
    np.save(src_path, src)
    np.save(ref_path, ref)
    reset_launch_counts()
    grid_knn.UNSAFE_COUNTS.clear()
    t0 = time.perf_counter()
    rc = cli_main(["--checkpoint", paths["best"], "--source", src_path,
                   "--reference", ref_path, "--output", out_path,
                   "--num_steps", str(STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    counts = dict(LAUNCH_COUNTS)
    patched = sum(u > 0 for u in grid_knn.UNSAFE_COUNTS)
    want = expect_counts(knn_topk=patched, fps=2, ball_query=2,
                         grid_interp=STEPS)
    out = np.load(out_path) if rc == 0 else None
    if rc != 0 or counts != want or out.shape != (N_POINTS, 3) or \
            not np.isfinite(out).all():
        fail(f"eval inference: rc {rc}, launches {counts} (expected {want})")
    print(f"[eval] cli.inference from {os.path.basename(paths['best'])}/: "
          f"output {out.shape} finite, launches {counts}, {infer_s:.3f} s")

    reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = compare_main([out_path, ref_path, "--json", "--device", "cuda"])
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    counts = dict(LAUNCH_COUNTS)
    result = json.loads(buf.getvalue())
    keys = {"precision", "recall", "f1", "chamfer_distance", "threshold",
            "generated_points", "reference_points"}
    want = expect_counts(rowmin=4)
    if rc != 0 or set(result) != keys or counts != want or not all(
            np.isfinite(v) for v in result.values()):
        fail(f"compare CLI: rc {rc}, keys {sorted(result)}, launches {counts}")
    print(f"[eval] cli.compare --json {N_POINTS}x{len(ref)}: {result}; "
          f"launches {counts}; {compare_s:.3f} s incl. file IO ({card})")
    compare_launches = counts["rowmin"]

    g = torch.from_numpy(out)[None].to(dev)
    r = torch.from_numpy(ref)[None].to(dev)
    reset_launch_counts()
    with torch.no_grad():
        vals = {"chamfer": metrics.chamfer_distance(g, r).item(),
                "hausdorff": metrics.hausdorff_distance(g, r).item(),
                "coverage@0.01": metrics.coverage_score(g, r).item(),
                "uniformity(k=8)": metrics.uniformity_score(g).item()}
        p, rec, f1 = metrics.precision_recall_f1(g, r)
        vals.update({"precision": p.item(), "recall": rec.item(),
                     "f1": f1.item()})
    counts = dict(LAUNCH_COUNTS)
    if counts["rowmin"] != 7 or counts["knn_topk"] != 1 or not all(
            np.isfinite(v) for v in vals.values()):
        fail(f"metrics: {vals}, launches {counts}")
    print(f"[eval] metrics on the output: {vals}; launches {counts} "
          "(uniformity: one k=9 kNN)")
    return compare_launches


# matplotlib is optional: without it the plotting functions return False
# and cli.progress saves its outputs as .npy, as in the JAX package
try:
    import matplotlib  # noqa: F401
    HAVE_MATPLOTLIB, NO_PLOTS = True, ""
except ImportError:
    HAVE_MATPLOTLIB = False
    NO_PLOTS = " (matplotlib is not installed here: no plots)"

# the CPU recomputation's bars for cli.test's metrics (card vs CPU)
TEST_RTOL = {"chamfer": 1e-4, "content": 1e-4, "hausdorff": 1e-4,
             "uniformity": 1e-4, "fidelity": 1e-4, "emd": 1e-3}
COVERAGE_ATOL = 1e-4
TEST_PAIRS, TEST_BATCH = 2, 2


def sinkhorn_emd_f64(pred: np.ndarray, target: np.ndarray,
                     epsilon: float = 0.01, num_iters: int = 100) -> float:
    """The port's Sinkhorn EMD (``evaluation.metrics._sinkhorn_emd``: the
    same iterations from zero potentials) in float64 numpy, in its scaling
    form u = 1 / (K (b v)), v = 1 / (K^T (a u)) with K = exp(-C / eps), which
    float64 holds without underflow for distances below ~7: the cost sum(P C)
    of the plan P = a u K v b."""
    from scipy.spatial.distance import cdist
    C = cdist(pred.astype(np.float64), target.astype(np.float64))
    if C.max() > 7.0:
        fail(f"sinkhorn_emd_f64: a distance of {C.max():.3g} underflows K")
    K = np.exp(-C / epsilon)
    a = np.full(len(pred), 1.0 / len(pred))
    b = np.full(len(target), 1.0 / len(target))
    v = np.ones(len(target))
    for _ in range(num_iters):
        u = 1.0 / (K @ (b * v))
        v = 1.0 / (K.T @ (a * u))
    return float(np.einsum("i,ij,j->", a * u, K * C, b * v))


def cpu_test_metrics(gen_dir: str, n_clouds: int, perms: dict) -> dict:
    """``cli.test``'s metric dict recomputed on the CPU from the files it
    saved: nearest neighbours from ``scipy.spatial.cKDTree`` in float64,
    the EMD in float64 (``sinkhorn_emd_f64``) on the card run's subsample
    permutations, each averaged over the clouds of the (one) batch as the
    ``Tester`` does."""
    from scipy.spatial import cKDTree
    from pointcloud_style_transfer_torch.cli.test import EMD_MAX_POINTS

    def load(name, i):
        return np.load(os.path.join(gen_dir, f"{name}_{i:04d}.npy"))

    def nn(a, b, k=1):  # distances from each point of a to b's nearest
        return cKDTree(b).query(a, k=k, workers=-1)[0]

    def chamfer(a, b):
        return (nn(a, b).mean() + nn(b, a).mean()) / 2

    def uniformity(p):
        d = nn(p, p, k=9)[:, 1:]  # drop the point itself
        mean_d = d.mean(axis=1)
        mu, sigma = mean_d.mean(), mean_d.std()
        return 1.0 / (1.0 + sigma / mu) if mu > 0 else 0.0

    def fidelity(p, t):
        pf = np.concatenate([p.mean(0), p.std(0, ddof=1)])
        tf = np.concatenate([t.mean(0), t.std(0, ddof=1)])
        return pf @ tf / (np.linalg.norm(pf) * np.linalg.norm(tf) + 1e-8)

    clouds = [{name: load(name, i).astype(np.float64) for name in
               ("sim_to_real", "real_to_sim", "original_sim",
                "original_real")} for i in range(n_clouds)]
    mean = lambda f: float(np.mean([f(c) for c in clouds]))  # noqa: E731
    m = {"chamfer_sim_to_real": mean(
             lambda c: chamfer(c["sim_to_real"], c["original_real"])),
         "chamfer_real_to_sim": mean(
             lambda c: chamfer(c["real_to_sim"], c["original_sim"])),
         "content_preservation": (
             mean(lambda c: chamfer(c["sim_to_real"], c["original_sim"]))
             + mean(lambda c: chamfer(c["real_to_sim"],
                                      c["original_real"]))) / 2}
    for tag, tgt in (("sim_to_real", "original_real"),
                     ("real_to_sim", "original_sim")):
        m[f"hausdorff_{tag}"] = mean(lambda c: max(
            nn(c[tag], c[tgt]).max(), nn(c[tgt], c[tag]).max()))
        m[f"coverage_{tag}"] = mean(
            lambda c: (nn(c[tgt], c[tag]) < 0.01).mean())
        m[f"uniformity_{tag}"] = mean(lambda c: uniformity(c[tag]))
        p_perm, t_perm = perms[tag]

        def sub(x, perm):
            return x if perm is None else x[perm[:EMD_MAX_POINTS]]
        m[f"emd_{tag}"] = mean(lambda c: sinkhorn_emd_f64(
            sub(c[tag], p_perm), sub(c[tgt], t_perm)))
        m[f"fidelity_{tag}"] = mean(lambda c: fidelity(c[tag], c[tgt]))
    return m


def phase_test(rng: np.random.Generator, dev: torch.device, card: str,
               work: str, paths: dict) -> dict:
    """``cli.test`` from the trained ``best_model`` on a test split of two
    synthetic 120,000-point pairs at ``--batch_size 2``: both directions,
    50 steps, every metric, the generated clouds and the plots saved; its
    launch counts asserted (set to 0 just before, read just after); its
    metrics held to the CPU's recomputation from the saved files. Returns
    the run's launch counts."""
    from pointcloud_style_transfer_torch.cli import test as cli_test
    split = os.path.join(work, "test_split")
    pre = PointCloudPreprocessor(total_points=N_POINTS,
                                 global_points=M_POINTS, seed=42)
    for i in range(TEST_PAIRS):
        pre.save_hierarchical_data(*lidar_scene_pair(rng, N_POINTS), split,
                                   f"test_{i:04d}")
    testers, emd = [], []
    orig_test, orig_emd = cli_test.Tester.test, cli_test.earth_mover_distance

    def test(self, *args, **kwargs):
        testers.append(self)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_test(self, *args, **kwargs)
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        return out

    def emd_peak(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = orig_emd(*args, **kwargs)
        torch.cuda.synchronize()
        emd.append(((time.perf_counter() - t0) * 1e3,
                    (torch.cuda.max_memory_allocated() - base) / 2**30))
        return out

    out_dir = os.path.join(work, "test_out")
    cli_test.Tester.test, cli_test.earth_mover_distance = test, emd_peak
    try:
        reset_launch_counts()
        grid_knn.UNSAFE_COUNTS.clear()
        t0 = time.perf_counter()
        rc = cli_test.main([
            "--checkpoint", paths["best"], "--test_data", split,
            "--output_dir", out_dir, "--batch_size", str(TEST_BATCH),
            "--num_inference_steps", str(STEPS), "--compute_all_metrics",
            "--save_generated", "--save_visualizations", "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = dict(LAUNCH_COUNTS)
        unsafe = list(grid_knn.UNSAFE_COUNTS)
    finally:
        cli_test.Tester.test, cli_test.earth_mover_distance = orig_test, \
            orig_emd
    if rc != 0 or len(testers) != 1:
        fail(f"test CLI: rc {rc}, {len(testers)} testers")
    # per direction: the grid cloud by cloud every step, the encoder's FPS
    # and ball query once for the batch; the metrics: 14 row minima
    # (4 Chamfer x 2, Hausdorff 2 x 2, coverage 1 x 2) and one k=9 kNN per
    # uniformity
    n_clouds = 2 * TEST_BATCH
    want = expect_counts(grid_interp=n_clouds * STEPS, fps=4, ball_query=4,
                         rowmin=14, knn_topk=sum(u > 0 for u in unsafe) + 2)
    if counts != want or len(unsafe) != n_clouds * STEPS:
        fail(f"test CLI: launches {counts} != {want} ({len(unsafe)} grid "
             "passes)")
    (run,) = os.listdir(out_dir)
    run = os.path.join(out_dir, run)
    with open(os.path.join(run, "test_results.json")) as f:
        got = json.load(f)["average_metrics"]
    gen_dir = os.path.join(run, "generated")
    names = sorted(os.listdir(gen_dir))
    gens = [np.load(os.path.join(gen_dir, f"{d}_{i:04d}.npy"))
            for d in ("sim_to_real", "real_to_sim") for i in range(TEST_PAIRS)]
    pngs = sorted(os.listdir(os.path.join(run, "visualizations")))
    want_pngs = [f"sample_{i:04d}_s2r.png" for i in range(TEST_PAIRS)] \
        if HAVE_MATPLOTLIB else []
    if list(got) != list(cli_test.METRIC_KEYS) or not all(
            np.isfinite(v) for v in got.values()) or len(names) != 8 or \
            not all(g.shape == (N_POINTS, 3) and np.isfinite(g).all()
                    for g in gens) or pngs != want_pngs:
        fail(f"test CLI: metrics {got}, files {names}, plots {pngs}")
    tester = testers[0]
    print(f"[test] cli.test from {os.path.basename(paths['best'])}/, "
          f"{TEST_PAIRS} pairs of {N_POINTS} points at --batch_size "
          f"{TEST_BATCH}, both directions, {STEPS} steps, every metric: "
          f"launches {counts} ({sum(u > 0 for u in unsafe)} grid steps "
          f"patched); {tester.seconds:.3f} s per batch (Tester.test, "
          f"{tester.seconds / n_clouds:.4f} s per generated cloud with its "
          f"metrics), {cli_s:.3f} s for the CLI with checkpoint load and "
          f"file IO ({card})")
    print(f"[test] EMD (Sinkhorn, [{TEST_BATCH}, 8192, 8192] float32, 100 "
          "iterations) per call: " + ", ".join(
              f"{ms:.1f} ms, peak {gib:.2f} GiB above the resident"
              for ms, gib in emd) + f" ({card})")
    print(f"[test] metrics: {got}; plots {pngs}{NO_PLOTS}")

    t0 = time.perf_counter()
    want_m = cpu_test_metrics(gen_dir, TEST_PAIRS, {
        tag: tuple(None if p is None else p.cpu().numpy() for p in perm)
        for tag, perm in tester.emd_perms[0].items()})
    gaps, bad = {}, []
    for k, v in got.items():
        if k.startswith("coverage"):
            gaps[k] = abs(v - want_m[k])
            ok = gaps[k] <= COVERAGE_ATOL
        else:
            gaps[k] = abs(v - want_m[k]) / abs(want_m[k])
            ok = gaps[k] <= TEST_RTOL[k.split("_")[0]]
        if not ok:
            bad.append(k)
    print(f"[test] card vs the CPU's recomputation from the saved clouds "
          f"(float64 cKDTree, float64 Sinkhorn on the card run's "
          f"permutations; {time.perf_counter() - t0:.1f} s): gaps "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + f"; bars rtol {TEST_RTOL}, coverage atol {COVERAGE_ATOL}")
    if bad:
        fail(f"test CLI: metrics beyond the CPU's bars in {bad}: card {got}"
             f", CPU {want_m}")
    return counts


def phase_visualize(work: str) -> None:
    """``cli.visualize`` on the eval phase's clouds: a PNG and a PLY of the
    generated cloud with every one of its points."""
    from pointcloud_style_transfer_torch.cli.visualize import \
        main as visualize_main
    png, ply = (os.path.join(work, f) for f in ("eval.png", "eval_out.ply"))
    t0 = time.perf_counter()
    rc = visualize_main(["--original", os.path.join(work, "eval_src.npy"),
                         "--generated", os.path.join(work, "eval_out.npy"),
                         "--reference", os.path.join(work, "eval_ref.npy"),
                         "--output", png, "--export_ply", ply])
    seconds = time.perf_counter() - t0
    with open(ply) as f:
        header = [next(f) for _ in range(7)]
        n_rows = sum(1 for _ in f)
    magic = b""
    if os.path.exists(png):
        with open(png, "rb") as f:
            magic = f.read(8)
    if rc != 0 or (magic == b"\x89PNG\r\n\x1a\n") != HAVE_MATPLOTLIB or \
            header[2] != f"element vertex {N_POINTS}\n" or n_rows != N_POINTS:
        fail(f"visualize CLI: rc {rc}, PNG {magic}, PLY header {header}, "
             f"{n_rows} rows")
    print(f"[visualize] cli.visualize: PNG "
          f"{os.path.getsize(png) if magic else 0} bytes{NO_PLOTS}, PLY of "
          f"{n_rows} vertices ({os.path.getsize(ply)} bytes) in "
          f"{seconds:.2f} s (host)")


def phase_progress(card: str, work: str) -> None:
    """``cli.progress`` over the train phase's experiment: inference with
    both epochs' checkpoints at 50 steps, the grid plotted."""
    from pointcloud_style_transfer_torch.cli.progress import \
        main as progress_main
    png = os.path.join(work, "progress.png")
    cwd = os.getcwd()
    os.chdir(work)  # without matplotlib it saves .npy files there
    try:
        reset_launch_counts()
        grid_knn.UNSAFE_COUNTS.clear()
        t0 = time.perf_counter()
        rc = progress_main([
            "--checkpoint_dir", os.path.join(work, "checkpoints", "smoke"),
            "--source", os.path.join(work, "eval_src.npy"),
            "--reference", os.path.join(work, "eval_ref.npy"), "--output",
            png, "--num_steps", str(STEPS), "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = dict(LAUNCH_COUNTS)
    want = expect_counts(grid_interp=2 * STEPS, fps=4, ball_query=4,
                         knn_topk=sum(u > 0 for u in grid_knn.UNSAFE_COUNTS))
    outputs = [png] if HAVE_MATPLOTLIB else [
        os.path.join(work, f"progress_epoch_{ep:04d}.npy") for ep in (0, 1)]
    if rc != 0 or counts != want or not all(
            os.path.exists(p) and os.path.getsize(p) for p in outputs):
        fail(f"progress CLI: rc {rc}, launches {counts} != {want}, outputs "
             f"{outputs}")
    print(f"[progress] cli.progress over 2 epochs' checkpoints, {STEPS} "
          f"steps each: {[os.path.basename(p) for p in outputs]}{NO_PLOTS}; "
          f"launches {counts}; {seconds:.2f} s ({card})")


def phase_benchmark(card: str, work: str) -> None:
    """``cli.benchmark --reps 2`` at ``Config()`` sizes: the forward sweep,
    hierarchical vs direct at 120k, the scaling sweep, 50-step sampling at
    B = 1 and B = 2, 4, 8; keys and finite values asserted."""
    from pointcloud_style_transfer_torch.cli.benchmark import \
        main as benchmark_main
    path = os.path.join(work, "benchmark.json")
    reset_launch_counts()
    grid_knn.UNSAFE_COUNTS.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = benchmark_main(["--reps", "2", "--device", "cuda",
                             "--output", path])
    seconds = time.perf_counter() - t0
    counts = dict(LAUNCH_COUNTS)
    with open(path) as f:
        res = json.load(f)
    samples = [res["sampling"]] + res["sampling_batched"]
    clouds = 3 * sum(s["batch"] for s in samples)  # warm-up + 2 timed calls
    want = expect_counts(grid_interp=clouds * STEPS, fps=2 * 3 * len(samples),
                         ball_query=2 * 3 * len(samples),
                         knn_topk=sum(u > 0 for u in grid_knn.UNSAFE_COUNTS))
    rows = res["forward"] + res["scaling"] + samples + [
        res["hierarchical_vs_direct"]]
    keys = {"device", "quick", "forward", "hierarchical_vs_direct", "scaling",
            "sampling", "sampling_batched"}
    if rc != 0 or set(res) != keys or counts != want or len(
            res["forward"]) != 12 or [s["batch"] for s in samples] != [
            1, 2, 4, 8] or not all(
            v is not None and np.isfinite(v) for r in rows for v in r.values()):
        fail(f"benchmark CLI: rc {rc}, keys {sorted(res)}, launches {counts}"
             f" != {want}, results {res}")
    print(f"[benchmark] cli.benchmark --reps 2, Config() sizes: "
          f"{seconds:.1f} s in all; launches {counts} ({card})")
    print(f"[benchmark] {json.dumps(res)}")


def phase_train_augmentation(rng: np.random.Generator, dev: torch.device,
                             card: str, paths: dict) -> None:
    """One training mini-step with ``use_augmentation=True`` at
    ``Config()`` width on the train split's first batch: both clouds
    augmented on the card (its draws made here and printed), the same
    augmentation on the CPU within 1e-6, a finite loss, the step's
    launches."""
    from pointcloud_style_transfer_torch.data import augment_points
    from pointcloud_style_transfer_torch.training import (make_optimizer,
                                                          train_step)
    from pointcloud_style_transfer_torch.training.ema import ema_init
    cfg = Config(use_augmentation=True)
    batch = next(iter(create_dataloaders(cfg.replace(
        processed_data_dir=paths["processed"]))[0]))
    sim, real = (torch.from_numpy(batch[k]).to(dev)
                 for k in ("sim_full", "real_full"))
    B = sim.shape[0]
    r = cfg.augmentation_rotation_range
    lo, hi = cfg.augmentation_scale_min, cfg.augmentation_scale_max
    draws = {f"augment_{side}": {
        "angles": torch.from_numpy(rng.uniform(-r, r, B).astype(np.float32)),
        "jitter": torch.from_numpy(rng.standard_normal(
            (B, N_POINTS, 3)).astype(np.float32)),
        "scales": torch.from_numpy(rng.uniform(lo, hi, B).astype(np.float32))}
        for side in ("sim", "real")}
    kw = dict(rotation_range=r, jitter_std=cfg.augmentation_jitter_std,
              scale_min=lo, scale_max=hi)
    aug_err = max((augment_points(x, **kw, **draws[f"augment_{side}"]).cpu()
                   - augment_points(x.cpu(), **kw,
                                    **draws[f"augment_{side}"])).abs().max()
                  .item() for x, side in ((sim, "sim"), (real, "real")))
    torch.manual_seed(0)
    model = PointCloudDiffusionModel(cfg, dev)
    params = dict(model.net.named_parameters())
    opt = make_optimizer(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(5)
    reset_launch_counts()
    terms, _ = train_step(model, make_schedule(cfg).to(dev), opt,
                          ema_init(params), sim, real, 1e-4,
                          draws={k: {n: v.to(dev) for n, v in d.items()}
                                 for k, d in draws.items()}, generator=gen)
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    terms = {k: v.item() for k, v in terms.items()}
    if counts != TRAIN_STEP_LAUNCHES or aug_err > 1e-6 or not all(
            np.isfinite(v) for v in terms.values()):
        fail(f"augmented mini-step: launches {counts}, augmentation card vs "
             f"CPU {aug_err}, loss terms {terms}")
    print(f"[train] augmentation: one mini-step, Config(use_augmentation="
          f"True), B={B}, {N_POINTS} points: loss terms "
          f"{ {k: round(v, 5) for k, v in terms.items()} } finite; launches "
          f"{counts}; draws: " + "; ".join(
              f"{side} angles {d['angles'].tolist()} rad, scales "
              f"{d['scales'].tolist()}, jitter N(0, 1) x "
              f"{cfg.augmentation_jitter_std} [{B}, {N_POINTS}, 3]"
              for side, d in draws.items())
          + f"; the augmentation card vs CPU {aug_err:.3g} ({card})")


PARALLEL_SEED = 30


def acc_grads_err(a: DiffusionTrainer, b: DiffusionTrainer) -> dict:
    """The largest difference of two trainers' accumulated gradients by
    part, over the train reference's bar for the part: ``GRAD_RTOL`` of
    each tensor's largest |g|, and for a pre-BN bias (zero in exact
    arithmetic) ``PRE_BN_BIAS_RATIO`` of its weight's largest |g|. 1.0 is
    the bar."""
    names = a.optimizer.names
    got = dict(zip(names, a.optimizer.acc_grads.split(a.optimizer.sizes)))
    want = dict(zip(names, b.optimizer.acc_grads.split(b.optimizer.sizes)))
    worst = {}
    for name in names:
        if pre_bn_bias(name):
            scale = want[name[:-len("bias")] + "weight"].abs().max()
            part, limit = "pre-BN bias", PRE_BN_BIAS_RATIO
        else:
            scale = want[name].abs().max()
            part = next(p for p in GRAD_RTOL if name.startswith(p))
            limit = GRAD_RTOL[part]
        ratio = float((got[name] - want[name]).abs().max() / scale)
        worst[part] = max(worst.get(part, 0.0), ratio / limit)
    return worst


def phase_parallel(dev: torch.device, card: str) -> dict:
    """``parallel/`` on a one-rank NCCL group on the card (NCCL puts no two
    ranks on one GPU and this machine has one), at full width: the ring row
    minimum, kNN and evaluation Chamfer at 120,000 x 120,000, the
    point-sharded and the data-parallel sampler at 120,000 / 30,000 points
    and 50 steps, and ``DiffusionTrainer(mesh_shape={"data": 1})`` for 3
    mini-steps, each against its single-device path on the same inputs and
    draws, launch counts set to 0 just before each run and read just after.
    Returns each kernel's launches by path."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.ops import chamfer_distance_l2
    from pointcloud_style_transfer_torch.parallel import (
        guided_sample_loop_dp, guided_sample_loop_sharded, make_mesh,
        ring_min_sq_dist)
    from pointcloud_style_transfer_torch.parallel.ring import (
        ring_chamfer_distance_l2, ring_knn)

    rng = np.random.default_rng(PARALLEL_SEED)
    points = make_mesh({"points": 1}, "cuda")
    data = make_mesh({"data": 1}, "cuda")
    print(f"[parallel] one-rank {dist.get_backend()} group, meshes "
          f"{points} and {data}; multi-card runs are unverified: this "
          f"machine has {torch.cuda.device_count()} card ({card})")
    launches = {}

    def counted(path: str, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches[path] = {k: v for k, v in LAUNCH_COUNTS.items() if v}
        return out, s

    q = torch.from_numpy(normalize_point_cloud(
        make_cloud(rng, N_POINTS))[0])[None].to(dev)
    r = torch.from_numpy(normalize_point_cloud(
        make_cloud(rng, N_POINTS))[0])[None].to(dev)
    for path, ring, dense, want in (
            ("ring_min_sq_dist", lambda: ring_min_sq_dist(q, r, points),
             lambda: min_sq_dist(q, r), {"rowmin": 1}),
            ("ring_knn", lambda: ring_knn(q, r, 3, points),
             lambda: knn(q, r, 3, backend="pallas"), {"knn_topk": 1}),
            ("ring_chamfer_distance_l2",
             lambda: ring_chamfer_distance_l2(q, r, points),
             lambda: chamfer_distance_l2(q, r), {"rowmin": 2})):
        got, _ = counted(path, ring)
        with torch.no_grad():
            ref = dense()
        for g, w in zip(*[(x,) if torch.is_tensor(x) else x
                          for x in (got, ref)]):
            if not torch.equal(g, w):
                fail(f"[parallel] {path} differs from the dense call")
        if launches[path] != want:
            fail(f"[parallel] {path} launches {launches[path]} != {want}")
        ms, dense_ms = cuda_ms(ring, 5), cuda_ms(dense, 5)
        print(f"[parallel] {path} at {N_POINTS} x {N_POINTS}: identical to "
              f"the dense call; launches {launches[path]}; {ms:.3f} ms "
              f"(dense {dense_ms:.3f} ms) ({card})")

    cfg = Config()
    torch.manual_seed(PARALLEL_SEED)
    net = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim,
                       compute_dtype=dtype_of(cfg))
    model = PointCloudDiffusionModel(cfg, dev, net=net)
    schedule = make_schedule(cfg).to(dev)
    src, cond = (torch.from_numpy(normalize_point_cloud(
        make_cloud(rng, N_POINTS, dup_frac=0.0))[0])[None].to(dev)
        for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
    draws = dict(
        x_init=torch.randn((1, N_POINTS, 3), generator=gen, device=dev),
        cond_priority=torch.rand((1, N_POINTS), generator=gen, device=dev),
        step_priorities=torch.rand((STEPS, 1, N_POINTS), generator=gen,
                                   device=dev),
        fps_starts=torch.randint(0, 512, (2, 1), generator=gen, device=dev))
    run = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, **draws)
    paths = (
        ("guided_sample_loop", lambda: guided_sample_loop(
            model, schedule, src, cond, **run)),
        ("guided_sample_loop_sharded", lambda: guided_sample_loop_sharded(
            model, schedule, src, cond, points, **run)),
        ("guided_sample_loop_dp", lambda: guided_sample_loop_dp(
            model, schedule, src, cond, data, STEPS, GUIDANCE,
            draws=[draws])))
    outs, firsts, secs = {}, {}, {}
    for path, fn in paths + paths[::-1]:  # in turns: a, b, c, c, b, a
        outs[path], s = counted(path, fn)
        firsts.setdefault(path, outs[path])
        secs.setdefault(path, []).append(s)
    for path, _ in paths:  # run to run: the voxel choice is exact
        if not torch.equal(firsts[path], outs[path]):
            fail(f"[parallel] two runs of {path} on the same inputs differ")
    single = launches["guided_sample_loop"]
    if single.get("grid_interp") != STEPS or single.get("fps") != 2 \
            or single.get("ball_query") != 2:
        fail(f"[parallel] single-device sampler launches {single}")
    for path, _ in paths[1:]:
        if not torch.equal(outs[path], outs["guided_sample_loop"]):
            err = float((outs[path] - outs["guided_sample_loop"]).abs().max())
            fail(f"[parallel] {path} differs from guided_sample_loop "
                 f"(max |diff| {err:.3e})")
        if launches[path] != single:
            fail(f"[parallel] {path} launches {launches[path]} != {single}")
    for path, _ in paths:
        print(f"[parallel] {path}: {N_POINTS} / {M_POINTS} points, {STEPS} "
              f"steps, guidance {GUIDANCE}, grid; identical output, "
              f"and identical in its two runs; "
              f"launches {launches[path]}; seconds per cloud "
              f"{', '.join(f'{t:.4f}' for t in secs[path])} ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in (
            "checkpoint_dir", "log_dir", "result_dir")}
        # float32, the bars' dtype: in bf16 the backward's roundings turn
        # the last-bit differences of its float atomics (index_add_,
        # scatter_add_) between two runs into differences of 2**-8
        tcfg = Config(**dirs, experiment_name="parallel", use_amp=False)
        trainers = [DiffusionTrainer(tcfg.replace(mesh_shape=mesh),
                                     resume=False, device=dev)
                    for mesh in ({}, {"data": 1})]
        batches = [tuple(np.stack([normalize_point_cloud(make_cloud(
            rng, N_POINTS))[0] for _ in range(tcfg.batch_size)])
            for _ in range(2)) for _ in range(3)]
        worst, loss_err = {}, 0.0
        for i, (sim, real) in enumerate(batches):
            terms = []
            for t, path in zip(trainers, ("train_step", "sharded_train_step")):
                (ld, _), _ = counted(path, lambda: t.train_step(
                    t._batch(sim), t._batch(real), 1e-4))
                terms.append({k: float(v) for k, v in ld.items()})
            if launches["sharded_train_step"] != launches["train_step"]:
                fail(f"[parallel] sharded mini-step launches "
                     f"{launches['sharded_train_step']}")
            loss_err = max(loss_err, max(
                abs(terms[1][k] / terms[0][k] - 1) for k in terms[0]))
            if i < 2:  # accumulated, not yet applied
                for part, r in acc_grads_err(*trainers[::-1]).items():
                    worst[part] = max(worst.get(part, 0.0), r)
        same = torch.equal(flat(trainers[0].params), flat(trainers[1].params))
        gaps = ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        if loss_err > 1e-5 or max(worst.values()) > 1.0:
            fail(f"[parallel] sharded trainer: loss {loss_err:.3e} relative "
                 f"(bar 1e-5), gradients over their bars by part: {gaps}")
        print(f"[parallel] DiffusionTrainer(mesh_shape={{'data': 1}}) vs "
              f"single-device, Config() width, float32, "
              f"B={tcfg.batch_size}, 3 mini-steps: loss terms "
              f"{loss_err:.3e} relative (bar 1e-5), accumulated gradients "
              f"over their bars by part (1 is the bar): {gaps}; parameters "
              f"after the optimizer step identical: {same}; launches a "
              f"mini-step {launches['sharded_train_step']} ({card})")
    dist.destroy_process_group()
    return launches


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
    with tempfile.TemporaryDirectory() as work:
        paths = phase_train(rng, dev, card, work)
        phase_train_reference(dev)
        records["rowmin"]["launches"] = phase_eval(dev, card, work, paths)
        records["rowmin"]["path"] = "cli.compare"
        test_counts = phase_test(np.random.default_rng(20), dev, card, work,
                                 paths)
        phase_visualize(work)
        phase_progress(card, work)
        phase_benchmark(card, work)
        phase_train_augmentation(np.random.default_rng(21), dev, card, paths)
    parallel = phase_parallel(dev, card)
    records["grid_topk"].update(launches=counts["grid_topk"],
                                path="cli.inference --fast")
    for name, rec in records.items():
        rec.setdefault("launches", counts[name])
        rec["cli_test_launches"] = test_counts[name]
        rec["parallel_launches"] = {path: got[name] for path, got in
                                    parallel.items() if name in got}
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
