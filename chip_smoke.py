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
   output shape and finiteness, launch counts (the CLI's one call is its
   engine's first, which runs eagerly: the loop's 50 grid interpolations,
   50 counted brute-force patch launches, 2 FPS and 2 ball queries; a
   later call captures the loop and replays it, and a replay counts the
   same launches), the per-step unsafe counts, seconds per cloud (replays)
   for the grid and for the brute-force kNN (``knn_backend="pallas"``), and
   a profiler breakdown of one grid cloud. Then the other serving paths at
   the same width, each with its launch counts asserted and its seconds
   per cloud (replays): ``knn_backend="pallas_f32packed"`` and
   ``"pallas_pruned"``, ``--fast`` (one ``grid_topk``, one
   counted patch), ``--source_dir`` with 3 clouds at ``--batch_size 2``
   (the grid flat-batched: one interpolation launch a step for each batch
   of two), and ``ddim_sample_loop`` for 5 steps.
   flat batch — the kd-grid's flat-batched path at full width (120,000-point
   clouds, 30,000 refs and 90,000 unknown queries each, ``Config()``'s
   grid): ``grid_interp`` on the two-cloud layout against its plain version
   (distances and positions identical, values within rtol 1e-6), in device
   time beside the two clouds' own launches;
   ``grid_knn_interpolate_layout_batched`` at B = 2 and B = 9 (a group of 8
   and a trailing one) against the per-cloud layout path: each cloud's
   layout order and unsafe count identical, values identical on the rows
   both prove safe and within rtol 1e-6 elsewhere, one ``grid_interp`` and
   at most one ``knn_topk`` a group, host and device ms a call both ways;
   ``_strip_interp_patch`` on cloud 0's unsafe rows against its plain run.
   graph — the samplers as captured programs at ``Config()`` (random
   weights, bf16, the grid): ``guided_sample_loop`` at B = 1 and B = 2 (50
   steps), ``--fast`` and ``ddim_sample_loop`` (5 steps), each on drawn-in
   draws: the eager body twice, the second time under
   ``torch.cuda.set_sync_debug_mode("error")`` (no sync allowed); through
   the capture runner the first call (eager) and the second (captured,
   then replayed), each identical to it (max |d| = 0) with the same unsafe
   counts and launch counts, their seconds, capture + instantiate
   seconds, replay seconds (best and spread), the graph's memory, and one
   profiled replay: its device busy share and the port's kernels it ran,
   by name (50 ``grid_interp``, 50 ``knn_topk``, 2 ``fps``, 2
   ``ball_query`` a cloud or batch); and ``knn_topk`` and
   ``knn_f32packed`` with their count on the device at the main path's
   shapes, identical to their plain twins at counts of 0, 1,825, 2,124
   and the whole buffer, in device time beside the same rows launched on
   their own (``knn_topk``) or the whole buffer (``knn_f32packed``). The
   B = 1 loop runs on ``"pallas_pruned"`` too (100 pruned passes a
   replay).
5. train — ``Config()`` defaults, nothing cut: four synthetic 120,000-point
   scene pairs through ``cli.preprocess`` (3 train, 1 val), then 2 epochs of
   ``cli.train`` (6 mini-steps, 2 optimizer steps, 2 validations, 2
   checkpoints): parameters and EMA move only on the 3rd and 6th mini-step,
   finite loss terms, launches per mini-step (2 kNN for the Chamfer's
   gradient, 2 FPS, 2 ball query, no row minimum), ms per mini-step and per
   optimizer step, peak memory (the first mini-step eager, the second
   captured, the rest replayed, each with its launches); a resumed
   trainer starts at epoch 2 with the same state; a profiled replayed
   mini-step; one float32 mini-step at 4,096
   points on the card and on the CPU with the same draws, the card
   replaying the CPU step's discrete selections (ReLU gates, max-pool
   argmaxes, Chamfer argmins): loss and gradients at the CPU tests'
   tolerances; the card's step with its own selections: every one that
   differs from the CPU's a near-tie, and few; for three clouds and draws
   from generators of its own.
   train graph — ``DiffusionTrainer.train_step`` / ``.eval_step`` as
   captured programs: in float32 at ``Config()`` width three trainers on
   the same batches (two eager, one captured), 6 mini-steps and 2 eval
   steps, the eager bodies under ``set_sync_debug_mode("error")``, loss
   terms, emit pattern, launches and states held at the ``GRAD_RTOL``
   bars (the eager state loaded into the others in place after the first
   optimizer step); then at ``Config()`` (bf16) ms of first, captured and
   replayed mini-steps and eval steps, an optimizer step of replays, the
   graphs' memory, a profiled eager and replayed mini-step.
6. eval — ``cli.inference`` from the trained ``best_model`` directory (the
   grid path), ``cli.compare --json`` of its output against the val pair's
   reference (4 row-min launches, the JAX package's JSON keys), and the
   metrics suite on the output.
7. test — ``cli.test`` from ``best_model`` on a test split of two synthetic
   120,000-point pairs at ``--batch_size 2``: sim->real and real->sim, 50
   steps, every metric, generated clouds and plots saved; its launches
   asserted (the first direction runs the loop eagerly, the second
   captures and replays it; one flat-batched pass and one counted patch a
   step: 100 grid interpolations, 4 FPS, 4 ball queries, 100 patches;
   14 row minima and two k=9 kNN); seconds per batch and the EMD's
   peak memory; its metrics held to the CPU's recomputation from the saved
   clouds (float64 nearest neighbours and Sinkhorn on the card run's
   subsample permutations; rtol 1e-4, coverage 1e-4 absolute, EMD 1e-3).
8. visualize — ``cli.visualize`` on the eval phase's clouds: a PNG and a
   120,000-vertex PLY.
9. progress — ``cli.progress`` over the train phase's two epochs at 50
   steps, launches asserted.
10. benchmark — ``cli.benchmark --reps 2`` at ``Config()`` sizes (forward
    sweep, hierarchical vs direct, scaling, 50-step sampling at B = 1, 2,
    4, 8: one grid interpolation a step and call at each), keys, finite
    values and launches asserted, its JSON printed.
11. train augmentation — one ``Config(use_augmentation=True)`` mini-step
    on the card: its draws printed, the augmentation card vs CPU within
    1e-6, a finite loss, the step's launches.
12. proof — the repo's end-to-end training proof, the port's scripts
    ``examples/e2e_training_proof_torch.py``, ``loss_spike_analysis_torch.py``
    and ``fast_mode_fidelity_torch.py`` at the JAX proof's settings: 64
    synthetic LiDAR pairs of 4,096 points (1,024 coarse) through
    ``cli.preprocess`` (51 / 7 / 6), 60 epochs of ``Config()`` widths at
    batch 2 (1,500 mini-steps, 500 optimizer steps, 13 validations and
    checkpoints), a transfer sample from the EMA weights, ``cli.test`` on
    ``best_model`` plain and with ``--fast``, the loss terms at 21
    timesteps, and the fast sampler against the full one on 3 val pairs:
    seconds, ms per replayed mini-step, the graphs captured by part, peak
    memory by part, each epoch's learning rate beside the rate one of its
    updates applied, every artifact as a line; held to the JAX package's
    committed artifacts (``docs/artifacts/e2e_training/``) by the bars of
    ``proof_bars``, within ``PROOF_BUDGET_S``.
13. tools — the repo's profiling, probe and demo scripts on the port
    (``examples/*_torch.py``, ``TOOLS``) at ``Config()`` width, each
    through its ``main`` at its defaults, its lines printed again under
    ``[tools]``: the sampler step's in-context attribution (nine variants,
    10 steps, each its own CUDA graph replayed 5 times; the ``full`` body
    identical to ``samplers._guided_body`` on the card; each variant's
    launches against what it stubs; a replayed full step's kernels by
    name), its B = 1, 2, 4 twin, the grid call's and the style encoder's
    stages, the voxel downsample and the train step at B = 1, 2, 4 (a
    replayed mini-step's kernels by name), points/s of the 50-step
    sampler at B = 1, 2, 4, 8 flat-batched and cloud by cloud, the unsafe
    rows at each of 50 steps, and the demo (8 synthetic pairs of 130,000
    points, 5 epochs, a transfer, ``cli.test`` both ways); every kernel of
    their paths launched, within ``TOOLS_BUDGET_S``. The kernels phase's
    ``[grid breakdown]`` is ``examples/profile_interp_stages_torch.py``'s
    ``stages`` on that phase's clouds and grid (``GRID_SHAPE``, ``GRID_TQ``,
    ``SLOT_CAP``).
14. parallel — ``parallel/`` on a one-rank NCCL group (NCCL puts no two
    ranks on one GPU): the ring row minimum, kNN (k=3) and evaluation
    Chamfer at 120,000 x 120,000, identical to the dense calls, with 1
    ``rowmin``, 1 ``knn_topk`` and 2 ``rowmin`` launches (eager by
    design: one-shot metric calls); ``guided_sample_loop_sharded`` and
    ``guided_sample_loop_dp`` at 120,000 / 30,000 points, 50 steps,
    guidance 7.5 on the grid, through the capture runner in turns (the
    single-device and data-parallel paths share one key; the point-sharded
    one has its own, its mesh's: eager, captured, replayed), identical to
    ``guided_sample_loop`` with the same draws and to its own eager body,
    the kernels each run launched the same, seconds per cloud;
    ``DiffusionTrainer(mesh_shape={"data": 1})`` with its steps captured,
    against the single-device trainer and the meshed trainer run eagerly,
    3 float32 mini-steps and 3 eval steps at ``Config()`` width: loss
    terms within 1e-5 of the single-device ones and identical to the eager
    meshed ones, the accumulated gradients at ``GRAD_RTOL``, a profiled
    replayed mini-step and eval step running the single-device replay's
    kernels; bf16 ms per mini-step of both trainers in turns; then
    ``[parallel graph]``: each collective of the meshed paths alone
    (``mesh.all_gather``, ``AllGather`` and ``AllReduceSum`` forward and
    backward, ``dist.all_reduce`` of the flat gradients) through
    ``run_captured(groups=)``, eager, captured, then 3 replays on new
    inputs, each identical to the eager body, a replay's device events by
    name (on one rank NCCL enqueues a device copy or nothing, no kernel),
    and the ranks' agreement's host microseconds a call; and the
    one-rank selections replay (``ranks_selections``: the one card's
    recorded choices replayed through the {points: 1} sampler, float32
    held to Chamfer-L2 1e-3, bf16 printed).

Then one JSON line with every kernel's numbers (``launches`` on the main
path, ``replay_launches`` by ``[graph]`` path, ``train_replay_launches``
of a replayed training mini-step, ``cli_test_launches`` in the test
phase, ``parallel_launches`` by ``[parallel]`` path, ``proof_launches`` of
the proof phase, ``tools_launches`` of the tools phase), the
``nvidia-smi`` name and power-limit line, and the final JSON line.
``--only`` with a comma list of ``graph``, ``train_graph``, ``parallel``,
``proof``, ``proof_full`` and ``tools`` runs the build
and those phases alone; ``proof_full`` is the proof at ``Config()``'s
120,000 / 30,000 points, where the kd-grid engages (``grid_interp``, its
counted ``knn_topk`` patch, ``--fast``'s ``grid_topk``), held to bars 1-3
against its own curve and to the spike rows' finiteness; it is in no
default run. ``--ranks n`` (a machine with n cards) runs the
build, then one process a card on an n-rank NCCL group
(``parallel_ranks``), every path held to its one-card counterpart on
card 0 with the same inputs and draws and every rank's result the same:
``[parallel graph]`` with an NCCL kernel in every replay; the
point-sharded sampler at {points: n} with its collectives inside its
graph, held to its eager body, and replaying the one card's recorded
choices (``ranks_selections``); ``guided_sample_loop_dp`` on {data: n}
(``ranks_dp``); the ring kNN, row minimum and Chamfers on {points: n}
and, at n = 4, on {data: 2, points: 2} (``ranks_ring``); at n = 4 the
point-sharded train and eval steps on {data: 2, points: 2}
(``ranks_point_sharded_step``; other n print a ``REFUSED`` line naming
the shape); ``DiffusionTrainer(mesh_shape={"data": n})`` captured vs
eager; each rank releases its graphs before it destroys its group. Then
``cli.test`` as one process and under ``torch.distributed.run
--nproc_per_node n`` (``ranks_cli_test``). All of it after the build
within ``RANKS_DEADLINE_S``. Without a card (or without the package
beside it) it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
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

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))

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
    DiffusionNet, PointCloudDiffusionModel, capture, ddim_sample_loop,
    ddim_step, ddim_timesteps, dtype_of, guided_sample_loop,
    guided_sample_loop_coarse, make_schedule, networks, samplers,
    time_embedding)
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
from pointcloud_style_transfer_torch.ops.kernels import _common
from pointcloud_style_transfer_torch.ops.kernels._common import (
    NVCC_FLAGS, library_path, nvcc_path, pairwise_sq_dist,
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
GRID_SHAPE, GRID_TQ, SLOT_CAP = grid_knn.GRID_SHAPE, 128, grid_knn.SLOT_CAP


def expect_counts(**launched: int) -> dict:
    """Every kernel's launch count, 0 where not named."""
    return {name: 0 for name in LAUNCH_COUNTS} | launched


def n_calls(counts: dict, n: int) -> dict:
    """``counts`` of ``n`` calls: a sampler's launches are the same in its
    eager first call and in each replay (``models.capture`` counts a
    replay's kernel nodes)."""
    return {name: n * v for name, v in counts.items()}


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


def empty_lib():
    """The empty kernel's library, beside the port's kernels (read at use:
    ``utils.cache.enable_compilation_cache`` may move them)."""
    return _common.BUILD_ROOT / "launch_floor" / "libempty.so"


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = empty_lib()
    lib.parent.mkdir(parents=True, exist_ok=True)
    (lib.parent / "empty.cu").write_text(EMPTY_SOURCE)
    empty = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(lib),
         str(lib.parent / "empty.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    paths = build_all()
    if empty.wait():
        fail(f"empty kernel: nvcc failed\n{empty.stdout.read().decode()}")
    dt = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernels built in {dt:.1f}s into "
          f"{_common.BUILD_ROOT}")
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
    lib = ctypes.CDLL(str(empty_lib()))
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
    n_unsafe = grid_knn.unsafe_counts()[-1]
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

    # one call's stages (examples/profile_interp_stages_torch.py) on this
    # script's grid, whatever PCST_PROF_* the shell sets
    stages_tool = example("profile_interp_stages_torch")
    knobs = dict(stages_tool.common.grid_knobs({}), grid_shape=GRID_SHAPE,
                 tq=GRID_TQ, slot_cap=SLOT_CAP)
    stages_tool.stages(query[0], ref[0], vals, knobs=knobs,
                       tag="[grid breakdown]")

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
    (never the exact one) on the rows it could not prove exact: one launch
    a pass over the ladder's buffer with the count on the device, whose
    query blocks past the count exit without work."""
    nq, m = query.shape[1], ref.shape[1]
    reset_launch_counts()
    grid_knn.UNSAFE_COUNTS.clear()
    d, i = grid_knn.grid_knn(query, ref, 3, exact=False)
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    n_unsafe = grid_knn.unsafe_counts()[-1]
    if counts != expect_counts(grid_topk=1, knn_f32packed=1):
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
        want = ({"grid_interp": STEPS, "knn_topk": STEPS} if backend == "auto"
                else {"grid_interp": 0, "knn_topk": STEPS})
    # the card's own run is a new model's first call: eager, and counted
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
    """torch, CUDA, cuBLAS and NCCL versions and the float32 matmul
    settings."""
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
    nccl = torch.cuda.nccl.version()
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else nccl
    return (f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuBLAS "
            f"{cublas}, NCCL {nccl}, float32 matmul precision "
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
        unsafe = grid_knn.unsafe_counts()
        if rc != 0:
            fail(f"inference CLI returned {rc}")
        out = np.load(out_path)
        if out.shape != (N_POINTS, 3) or not np.isfinite(out).all():
            fail(f"output shape {out.shape} / finite "
                 f"{bool(np.isfinite(out).all())}")
        patched = sum(u > 0 for u in unsafe)
        last_tier = grid_knn._fallback_caps(4096, N_POINTS - M_POINTS)[-1]
        # the CLI's engine is new, so its loop runs eagerly in this call
        # (the capture runner captures a key's second call): one counted
        # patch launch a step, whatever the unsafe count
        expected = expect_counts(knn_topk=STEPS, fps=2, ball_query=2,
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
              f"{max(unsafe)}; {patched} steps with rows for knn_topk, "
              f"{sum(u > last_tier for u in unsafe)} of them all-brute "
              f"(> {last_tier} rows); per step: {unsafe}")

        # the other serving paths at the same width: each driven once with
        # the counts set to 0 just before and read just after (that run is
        # also its warm-up), then timed. The grid and the brute path are
        # timed first, with no other engine on the card yet, so that their
        # seconds per cloud compare with earlier readings of this script.
        def time_engine(name: str, eng: DiffusionInference) -> None:
            times = []
            n_cap = len(capture.CAPTURES)
            for _ in range(3):
                t0 = time.perf_counter()
                eng.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            best = min(times)
            captured = len(capture.CAPTURES) - n_cap
            print(f"[main] {name}: seconds per cloud {best:.4f} (runs "
                  f"{', '.join(f'{t:.4f}' for t in times)}; captures "
                  f"{captured}, the best a replay), {N_POINTS / best:.0f} "
                  f"points/s ({card})")
            return captured

        # each engine is new: its first call runs eagerly, and the timed
        # calls after it capture and replay (every backend, the pruned
        # kNN's too)
        for name, backend, fast, want in (
                ("brute (pallas)", "pallas", False,
                 expect_counts(knn_topk=STEPS, fps=2, ball_query=2)),
                ("f32-packed (pallas_f32packed)", "pallas_f32packed", False,
                 expect_counts(knn_f32packed=STEPS, fps=2, ball_query=2)),
                ("pruned (pallas_pruned)", "pallas_pruned", False,
                 expect_counts(knn_pruned=2 * STEPS, fps=2, ball_query=2)),
                ("fast (--fast, auto)", "auto", True,
                 expect_counts(grid_topk=1, knn_topk=1, fps=2,
                               ball_query=2))):
            path = save_checkpoint(os.path.join(tmp, f"{backend}.pt"),
                                   cfg.replace(knn_backend=backend), params,
                                   stats)
            eng = DiffusionInference(path, seed=1, device=dev, fast=fast)
            reset_launch_counts()
            grid_knn.UNSAFE_COUNTS.clear()
            out = eng.transfer_style_hierarchical(src, ref, STEPS, GUIDANCE)
            torch.cuda.synchronize()
            got = dict(LAUNCH_COUNTS)
            if fast:  # one upsample: the grid pass and its counted patch
                unsafe = grid_knn.unsafe_counts()
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
            if time_engine(name, eng) != 1:
                fail(f"{name}: its timed calls did not capture once")
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
    unsafe = grid_knn.unsafe_counts()
    # two batches of two clouds (the tail padded with its last pair): the
    # encoder's kernels take the batch at once, and so does the grid, one
    # flat-batched pass and one counted patch launch a step; the first
    # batch runs the loop eagerly, the second captures and replays it;
    # four unsafe counts a step, one a cloud
    want = n_calls(expect_counts(grid_interp=STEPS, fps=2, ball_query=2,
                               knn_topk=STEPS), 2)
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
    want = expect_counts(grid_interp=5, fps=10, ball_query=10, knn_topk=5)
    secs = []
    for _ in range(3):  # eager, then captured and replayed, then replayed
        reset_launch_counts()
        grid_knn.UNSAFE_COUNTS.clear()
        t0 = time.perf_counter()
        out = ddim_sample_loop(engine.model, make_schedule(cfg), shape_like,
                               cond, num_inference_steps=5, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = dict(LAUNCH_COUNTS)
        if got != want or tuple(out.shape) != (1, N_POINTS, 3) \
                or not torch.isfinite(out).all():
            fail(f"ddim_sample_loop call {len(secs)}: launches {got} != "
                 f"{want}, output {tuple(out.shape)}")
    print(f"[main] ddim_sample_loop, 5 steps at {N_POINTS} points: output "
          f"{tuple(out.shape)} finite; launches each call {got}; first call "
          f"(eager) {secs[0]:.4f} s, second (capture + replay) "
          f"{secs[1]:.4f} s, replay {secs[2]:.4f} s ({card})")


def patch_launches(unsafe: list, groups) -> int:
    """The brute-force patch launches of a run of grid passes: one counted
    launch for each group of clouds (one flat-batched pass, or one
    cloud's), whatever its unsafe rows. ``unsafe`` is
    ``grid_knn.unsafe_counts()``, one entry a cloud; ``groups`` the clouds
    of each pass in order."""
    if sum(groups) != len(unsafe):
        fail(f"{len(unsafe)} grid unsafe counts for {sum(groups)} clouds in "
             f"{len(groups)} passes")
    return len(groups)


def batch_groups(B: int) -> list:
    """The clouds of each pass of a B-cloud grid upsample: flat groups of
    at most ``grid_knn._BATCHED_MAX_GROUP``."""
    g = grid_knn._BATCHED_MAX_GROUP
    return [min(g, B - s) for s in range(0, B, g)]


def call_times(fn, reps: int = 3) -> tuple[float, float]:
    """(host ms, device ms) of one call of ``fn``: the wall clock with a
    sync after each call, and the summed device time of every kernel the
    profiler traced, a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    return host, dev / 1e3 / reps


FLAT_SEED = 24
FLAT_BATCHES = (2, 9)  # one group; a group of 8 and a trailing one


def flat_safe(q: torch.Tensor, r: torch.Tensor, v: torch.Tensor
              ) -> list:
    """Per cloud of ``q`` [B, Nq, 3], the grid pass's safe flags in that
    cloud's layout order as the flat-batched entry point groups them."""
    B, Nq = q.shape[:2]
    out, s = [], 0
    for g in batch_groups(B):
        if g == 1:
            st = grid_knn._build_struct(r[s], GRID_SHAPE, skip_z_sort=True)
            _, safe, qid, _ = grid_knn._query_pass(
                st, q[s], 3, GRID_SHAPE, GRID_TQ, SLOT_CAP, values=v[s],
                layout_out=True)
        else:
            sb = grid_knn._build_struct_batched(r[s:s + g], GRID_SHAPE)
            _, safe, qid, _ = grid_knn._query_pass(
                sb, q[s:s + g], 3, GRID_SHAPE, GRID_TQ, SLOT_CAP,
                values=v[s:s + g], layout_out=True)
        for b in range(g):
            out.append(safe[(qid >= b * Nq) & (qid < (b + 1) * Nq)])
        s += g
    return out


def phase_flat_batch(dev: torch.device, card: str) -> dict:
    """The flat-batched grid at full width (120,000-point clouds: 30,000
    coarse refs, 90,000 unknown queries, ``Config()``'s grid): the batched
    layout's ``grid_interp`` against its plain version and in device time
    beside the two clouds' own launches; ``grid_knn_interpolate_layout_
    batched`` at B = 2 and 9 against the per-cloud layout path (each
    cloud's layout order identical, values identical on rows both prove
    safe, launches a group); the strip patch against its plain run.
    Returns numbers for the kernels line."""
    rng = np.random.default_rng(FLAT_SEED)
    B = max(FLAT_BATCHES)
    q, r = [], []
    for _ in range(B):
        pts = normalize_point_cloud(make_cloud(rng, N_POINTS))[0]
        q.append(pts[M_POINTS:])
        r.append(pts[:M_POINTS])
    q = torch.from_numpy(np.stack(q)).to(dev)
    r = torch.from_numpy(np.stack(r)).to(dev)
    v = torch.from_numpy(rng.standard_normal((B, M_POINTS, 3)).astype(
        np.float32)).to(dev)
    Nq = q.shape[1]

    # the batched layout of two clouds: kernel against plain
    sb = grid_knn._build_struct_batched(r[:2], GRID_SHAPE)
    sl = grid_knn._layout_slots(sb, q[:2], GRID_SHAPE, GRID_TQ, SLOT_CAP)
    vals = grid_knn._sorted_values(sb, v[:2])
    lo = sl.tb[:, None] * sb.M_pad
    busy = sl.en > sl.st
    if not (((sl.st >= lo) & (sl.en <= lo + sb.M)) | ~busy).all():
        fail("[flat batch] a tile's run leaves its own cloud's refs")
    args = (sl.q_pad, sb.refs_pad, vals, sl.st, sl.en, 3)
    v_k, d_k = grid_interp_cuda(*args, n_real=sl.n_real)
    v_p, d_p = grid_interp_plain(*args, n_real=sl.n_real)
    d_t, i_t = grid_topk_cuda(sl.q_pad, sb.refs_pad, sl.st, sl.en, 3,
                              n_real=sl.n_real)
    d_tp, i_tp = grid_topk_plain(sl.q_pad, sb.refs_pad, sl.st, sl.en, 3,
                                 n_real=sl.n_real)
    check_equal("[flat batch] grid_interp", d_k.view(torch.int32),
                d_p.view(torch.int32), "distance bits")
    check_equal("[flat batch] grid_topk", i_t, i_tp, "positions")
    check_equal("[flat batch] grid_topk", d_t.view(torch.int32),
                d_tp.view(torch.int32), "distance bits")
    full = d_p[:, -1] < 1e29
    err = values_err(v_k[full], v_p[full])
    if not np.isfinite(err) or not torch.isfinite(v_k).all():
        fail("[flat batch] grid_interp values differ from the plain version "
             "beyond rtol 1e-6, atol 1e-6 * max|v|")
    ms_flat = device_ms(lambda: grid_interp_cuda(*args, n_real=sl.n_real),
                        "grid_interp")
    ms_one = []
    for b in range(2):
        st1, sl1 = grid_tables(q[b:b + 1], r[b:b + 1])
        args1 = (sl1.q_pad, st1.refs_pad, grid_knn._sorted_values(st1, v[b]),
                 sl1.st, sl1.en, 3)
        ms_one.append(device_ms(lambda: grid_interp_cuda(
            *args1, n_real=sl1.n_real), "grid_interp"))
    print(f"[flat batch] grid_interp on the B=2 layout ({sl.st.shape[0]} "
          f"tiles, refs {tuple(sb.refs_pad.shape)}): distance bits and "
          f"positions identical to the plain versions, max |v| err {err:.3g};"
          f" runs inside their cloud's refs; device time {ms_flat:.4f} ms in "
          f"one launch against {ms_one[0]:.4f} + {ms_one[1]:.4f} ms for the "
          f"two clouds' own launches ({card})")

    # the entry point, flat against cloud by cloud
    out = {"flat_b2_ms": ms_flat, "per_cloud_ms": ms_one}
    for B in FLAT_BATCHES:
        groups = batch_groups(B)
        reset_launch_counts()
        grid_knn.UNSAFE_COUNTS.clear()
        v_lay, qid = grid_knn.grid_knn_interpolate_layout_batched(
            q[:B], r[:B], v[:B])
        torch.cuda.synchronize()
        got = dict(LAUNCH_COUNTS)
        unsafe = grid_knn.unsafe_counts()
        want = expect_counts(grid_interp=len(groups),
                             knn_topk=patch_launches(unsafe, groups))
        if got != want or len(unsafe) != B:
            fail(f"[flat batch] B={B}: launches {got} != {want} "
                 f"({len(unsafe)} unsafe counts)")
        grid_knn.UNSAFE_COUNTS.clear()
        one = [grid_knn.grid_knn_interpolate_layout(q[b], r[b], v[b])
               for b in range(B)]
        unsafe_one = grid_knn.unsafe_counts()
        if unsafe_one != unsafe:
            fail(f"[flat batch] B={B}: unsafe rows a cloud {unsafe} flat, "
                 f"{unsafe_one} cloud by cloud")
        safe_flat = flat_safe(q[:B], r[:B], v[:B])
        n_diff, worst, n_both = 0, 0.0, 0
        for b, (v1, qid1) in enumerate(one):
            mine = (qid >= b * Nq) & (qid < (b + 1) * Nq)
            real1 = qid1 < Nq
            if not torch.equal(qid[mine] - b * Nq, qid1[real1]):
                fail(f"[flat batch] B={B}: cloud {b}'s layout order differs "
                     "from its own pass's")
            st1 = grid_knn._build_struct(r[b], GRID_SHAPE, skip_z_sort=True)
            _, safe1, _, _ = grid_knn._query_pass(
                st1, q[b], 3, GRID_SHAPE, GRID_TQ, SLOT_CAP, values=v[b],
                layout_out=True)
            both = safe_flat[b] & safe1[real1]
            a, w = v_lay[mine], v1[real1]
            n_both += int(both.sum())
            if not torch.equal(a[both], w[both]):
                fail(f"[flat batch] B={B}: cloud {b}'s values differ on rows "
                     "both paths prove safe")
            if not np.isfinite(values_err(a, w)):
                fail(f"[flat batch] B={B}: cloud {b}'s values differ beyond "
                     "rtol 1e-6")
            n_diff += int((a != w).any(1).sum())
            worst = max(worst, float((a - w).abs().max()))
        flat_t = call_times(
            lambda: grid_knn.grid_knn_interpolate_layout_batched(
                q[:B], r[:B], v[:B]))
        one_t = call_times(lambda: [grid_knn.grid_knn_interpolate_layout(
            q[b], r[b], v[b]) for b in range(B)])
        out[f"B{B}"] = dict(launches={k: n for k, n in got.items() if n},
                            unsafe=unsafe, rows_differ=n_diff,
                            host_ms=[flat_t[0], one_t[0]],
                            device_ms=[flat_t[1], one_t[1]])
        print(f"[flat batch] grid_knn_interpolate_layout_batched B={B} "
              f"(groups {groups}) x {Nq} queries x {M_POINTS} refs: launches "
              f"{out[f'B{B}']['launches']}; unsafe rows a cloud {unsafe} "
              f"(the same cloud by cloud); each cloud's layout order that of "
              f"its own pass; values identical on the {n_both} rows both "
              f"paths prove safe, {n_diff} rows differ in all, largest "
              f"|diff| {worst:.3g}; a call {flat_t[0]:.2f} ms host, "
              f"{flat_t[1]:.2f} ms device, cloud by cloud {one_t[0]:.2f} / "
              f"{one_t[1]:.2f} ms ({card})")

    # the strip patch: the unsafe rows of cloud 0 (at most 4,096), kernel
    # against the plain version on the same inputs
    st0 = grid_knn._build_struct(r[0], GRID_SHAPE)
    _, unsafe0 = grid_knn._query_pass(st0, q[0], 3, GRID_SHAPE, GRID_TQ,
                                      SLOT_CAP, values=v[0])
    ids = unsafe0.nonzero()[:, 0][:4096].int()
    ids = torch.cat([ids, ids.new_full((4096 - len(ids),), Nq)])
    vals0 = grid_knn._sorted_values(st0, v[0])
    reset_launch_counts()
    ids_k, v_sk, fail_k = grid_knn._strip_interp_patch(
        st0, GRID_SHAPE, q[0], ids, vals0, 3, 1e-8)
    torch.cuda.synchronize()
    launched = LAUNCH_COUNTS["grid_interp"]
    kernel = grid_knn.grid_interp
    grid_knn.grid_interp = grid_interp_plain
    try:
        ids_p, v_sp, fail_p = grid_knn._strip_interp_patch(
            st0, GRID_SHAPE, q[0], ids, vals0, 3, 1e-8)
    finally:
        grid_knn.grid_interp = kernel
    real = ids_p < Nq
    check_equal("[flat batch] strip patch", ids_k, ids_p, "row ids")
    check_equal("[flat batch] strip patch", fail_k, fail_p, "fail flags")
    s_err = values_err(v_sk[real], v_sp[real])
    if launched != 1 or not np.isfinite(s_err):
        fail(f"[flat batch] strip patch: {launched} grid_interp launches, "
             f"values err {s_err}")
    print(f"[flat batch] _strip_interp_patch, {int(real.sum())} unsafe rows "
          f"of cloud 0 in 32 tiles of 128, 64-block strips: one grid_interp "
          f"launch; ids and fail flags identical to its plain run "
          f"({int(fail_k.sum())} rows fail), max |v| err {s_err:.3g} ({card})")
    return out


GRAPH_SEED = 40
# what one replay of a captured sampler launches of the port's kernels at
# Config(): every step's grid interpolation and its one counted patch
# launch (the fallback ladder on the device), the encoder's two FPS and two
# ball queries; at B = 2 the same (the grid and the encoder take the batch)
GRAPH_LAUNCHES = expect_counts(grid_interp=STEPS, knn_topk=STEPS, fps=2,
                               ball_query=2)
DDIM_STEPS = 5


@contextlib.contextmanager
def eager_samplers():
    """Within the block the samplers run their body eagerly on the card
    (the captured runner replaced by a direct call), for the comparisons
    with the captured loop and the sync check."""
    own = samplers.run_captured
    samplers.run_captured = lambda key, body, inputs, owner, **kw: body(
        inputs)
    try:
        yield
    finally:
        samplers.run_captured = own


def port_kernel(key: str):
    """The ``LAUNCH_COUNTS`` name of a device kernel in a profiler key (its
    demangled name), or None for a kernel of PyTorch's own."""
    for name in LAUNCH_COUNTS:
        ident = "knn_pruned_pass" if name == "knn_pruned" else name
        if re.search(rf"(?<![A-Za-z0-9_]){ident}(_global|_stream)?_kernel",
                     key):
            return name
    return None


def profiled_replay(fn, want: dict, groups=()):
    """One replay ``fn`` of a captured sampler under the profiler: (its
    result, the port's kernels the device ran by ``LAUNCH_COUNTS`` name,
    every device kernel and copy it ran, device busy ms, wall ms). A replay
    runs every kernel node of its fixed graph, so while the traced port
    kernels differ from ``want`` the replay is profiled again, at most
    twice: the card's tracer has dropped kernel records (``device_ms``; one
    ``knn_topk`` of a 50-step replay once). Each retake is noted on stderr;
    the caller holds the last trace to ``want``. Used for captured paths
    only: an eager path's launches are its ``LAUNCH_COUNTS``. A replay
    that runs collectives on ``groups`` is retaken on every rank of them
    or on none (``capture.agree``), so that no rank runs one alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, n_all, busy = expect_counts(), 0, 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            busy += e.self_device_time_total / 1e3
            n_all += e.count
            name = port_kernel(e.key)
            if name:
                launches[name] += e.count
        if capture.agree(groups, int(launches == want)):
            break
        print(f"profiled_replay: traced {launches}, expected {want} (trace "
              f"{attempt + 1} of at most 3)", file=sys.stderr)
    return out, launches, n_all, busy, wall * 1e3


def graph_run(what: str, run, want: dict, card: str, reps: int = 5) -> dict:
    """A sampler call ``run`` (its draws passed in) on the card: its eager
    body twice, the second time under ``set_sync_debug_mode("error")``;
    then through the capture runner its first call (eager, the warm-up)
    and its second (the capture and instantiation, timed by
    ``models.capture``, and a replay), each identical to the eager body
    (max |d| = 0) with the same unsafe counts and ``want`` launches;
    ``reps`` replays timed, each identical; one profiled replay, its port
    kernels by name against ``want``."""
    # the eager body first: once to build its lazy tables (a host copy
    # each, once a process), then under the sync check
    grid_knn.UNSAFE_COUNTS.clear()
    with eager_samplers():
        eager = run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager_checked = run()
        except RuntimeError as e:
            fail(f"[graph] {what}: the eager body synchronised: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    eager_unsafe = grid_knn.unsafe_counts()
    if not torch.equal(eager, eager_checked):
        fail(f"[graph] {what}: two eager runs on the same draws differ")
    n_cap = len(capture.CAPTURES)
    calls = []  # (seconds, output, launches, unsafe counts) a call
    for _ in range(2):  # the first call (eager), the second (captured)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        reset_launch_counts()
        grid_knn.UNSAFE_COUNTS.clear()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out, dict(LAUNCH_COUNTS),
                      grid_knn.unsafe_counts()))
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2**30
    if len(capture.CAPTURES) != n_cap + 1:
        fail(f"[graph] {what}: {len(capture.CAPTURES) - n_cap} captures in "
             "two calls")
    cap = capture.CAPTURES[-1]
    (first_s, first, _, unsafe), (second_s, second, _, _) = calls
    for i, (_, out, launched, u) in enumerate(calls):
        if launched != want or u != unsafe:
            fail(f"[graph] {what}: call {i + 1} launched {launched} != "
                 f"{want}, unsafe counts {u} vs {unsafe}")
    times_s = []
    grid_knn.UNSAFE_COUNTS.clear()
    reset_launch_counts()
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times_s.append(time.perf_counter() - t0)
        if not torch.equal(out, first):
            fail(f"[graph] {what}: a replay differs from the first call "
                 f"({(out - first).abs().max().item()})")
    if grid_knn.unsafe_counts() != unsafe * reps or dict(
            LAUNCH_COUNTS) != n_calls(want, reps):
        fail(f"[graph] {what}: {reps} replays' unsafe counts or launches "
             f"{dict(LAUNCH_COUNTS)} differ")
    diff = max((eager - out).abs().max().item() for out in (first, second))
    if not (torch.equal(eager, first) and torch.equal(eager, second)) \
            or eager_unsafe != unsafe * 2:
        fail(f"[graph] {what}: first / captured vs eager max |d| {diff}, "
             f"unsafe counts {unsafe} vs {eager_unsafe}")
    if not torch.isfinite(first).all():
        fail(f"[graph] {what}: output not finite")
    reset_launch_counts()
    _, launches, n_all, busy, wall = profiled_replay(run, want)
    if launches != want:
        fail(f"[graph] {what}: a replay launched {launches} != {want}")
    best = min(times_s)
    spread = (max(times_s) - best) / best
    print(f"[graph] {what}: eager first call and captured second call == "
          f"eager body on the same draws (max |d| {diff}), no sync in the "
          f"eager body (set_sync_debug_mode 'error'); launches a call "
          f"{dict((k, v) for k, v in want.items() if v)}; unsafe rows a pass "
          f"{unsafe[:8]}{'...' if len(unsafe) > 8 else ''}")
    print(f"[graph] {what}: first call (eager) {first_s:.3f} s; second call "
          f"{second_s:.3f} s (capture + instantiate {cap['capture_s']:.3f} "
          f"s, then a replay); replay s/call best {best:.4f}, spread "
          f"{100 * spread:.1f}% (runs {', '.join(f'{t:.4f}' for t in times_s)}); "
          f"graph memory (reserved growth at the capture) {pool_gib:.3f} GiB "
          f"({card})")
    print(f"[graph] {what}: profiled replay: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall:.1f}%), {n_all} device kernels "
          f"and copies, the port's {dict((k, v) for k, v in launches.items() if v)}")
    return {"first_s": first_s, "second_s": second_s, **cap,
            "replay_best_s": best, "replay_spread": spread,
            "busy_share": busy / wall, "device_ms": busy,
            "pool_gib": pool_gib, "launches": launches}


def predicated_knn(dev: torch.device, card: str) -> dict:
    """``knn_topk`` with the count on the device at the main path's shapes
    (a 114,688-row layout buffer x 30,000 refs, k = 3; the plan made for
    the ladder's first tier), bit-identical to its plain twin at counts of
    0, 1,825 (the sampler's median patch), a count that ends inside a
    cluster's query block, and the whole buffer; device ms at 1,825 rows
    beside the unpredicated launch on the same rows gathered."""
    rng = np.random.default_rng(GRAPH_SEED)
    n_buf, m = 114_688, M_POINTS
    q = torch.from_numpy(normalize_point_cloud(make_cloud(rng, n_buf))[0]
                         )[None].to(dev)
    r = torch.from_numpy(normalize_point_cloud(make_cloud(rng, m))[0]
                         )[None].to(dev)
    perm = torch.from_numpy(rng.permutation(n_buf).astype(np.int32))
    row_ids = perm[None].to(dev).contiguous()
    plan_rows = grid_knn._patch_plan_rows(4096)
    S = knn_topk_plan(1, plan_rows, m)
    out = {"plan_rows": plan_rows, "S": S}
    for n in (0, 1825, 1825 + 37 * 8 + 3, n_buf):
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        d, i = knn_topk_cuda(q, r, 3, row_ids=row_ids, count=count,
                             plan_rows=plan_rows)
        dp, ip = knn_topk_plain(q, r, 3, row_ids, count)
        check_equal(f"[graph] knn_topk count {n}", i, ip)
        check_equal(f"[graph] knn_topk count {n}", d.view(torch.int32),
                    dp.view(torch.int32), "distance bits")
    count = torch.tensor([1825], dtype=torch.int32, device=dev)
    ms = device_ms(lambda: knn_topk_cuda(q, r, 3, row_ids=row_ids,
                                         count=count, plan_rows=plan_rows),
                   "knn_topk")
    rows = q[:, perm[:1825].long().to(dev)].contiguous()
    ms_plain_launch = device_ms(lambda: knn_topk_cuda(rows, r, 3), "knn_topk")
    bound = no_fma_ms(1825 * m * 8)
    out.update(count_ms=ms, gathered_ms=ms_plain_launch, bound_ms=bound)
    print(f"[graph] knn_topk with the count on the device: {n_buf}-row "
          f"buffer x {m} refs, k=3, S={S} (planned for {plan_rows} rows): "
          f"identical to its plain twin at counts 0, 1825, 2124, {n_buf}; "
          f"count 1825: {ms:.4f} ms device vs {ms_plain_launch:.4f} ms for "
          f"the same rows gathered and launched with their own plan, no-FMA "
          f"bound {bound:.4f} ms ({card})")
    # the f32-packed kernel, which grid_knn(exact=False)'s ladder launches
    # the same way (refs padded to its 2,048 tile)
    m_total = knn_packed.padded_refs(m, 2048)
    for n in (0, 1825, 1825 + 37 * 8 + 3, n_buf):
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        keys = knn_f32packed_keys_cuda(q, r, 3, m_total, row_ids=row_ids,
                                       count=count, plan_rows=plan_rows)
        want = knn_f32packed_keys_plain(q, r, 3, m_total, row_ids, count)
        check_equal(f"[graph] knn_f32packed count {n}", keys.view(torch.int32),
                    want.view(torch.int32), "keys")
    count = torch.tensor([1825], dtype=torch.int32, device=dev)
    f_ms = device_ms(lambda: knn_f32packed_keys_cuda(
        q, r, 3, m_total, row_ids=row_ids, count=count, plan_rows=plan_rows),
        "knn_f32packed")
    whole = q[:, perm.long().to(dev)].contiguous()
    f_whole_ms = device_ms(lambda: knn_f32packed_keys_cuda(
        whole, r, 3, m_total), "knn_f32packed")
    out.update(f32packed_count_ms=f_ms, f32packed_buffer_ms=f_whole_ms)
    print(f"[graph] knn_f32packed with the count on the device (the same "
          f"buffer, grid_knn(exact=False)'s ladder): identical to its plain "
          f"twin at counts 0, 1825, 2124, {n_buf}; count 1825: {f_ms:.4f} ms "
          f"device vs {f_whole_ms:.4f} ms for the whole {n_buf}-row buffer "
          f"without a count ({card})")
    return out


def phase_graph(dev: torch.device, card: str) -> dict:
    """The samplers as captured programs at ``Config()`` (random weights,
    bf16, the kd-grid): ``guided_sample_loop`` at 120,000 / 30,000 points,
    50 steps, guidance 7.5 at B = 1 and B = 2, ``guided_sample_loop_coarse``
    (``--fast``) at B = 1 and ``ddim_sample_loop`` for 5 steps, each
    through ``graph_run``, the B = 1 loop also on ``"pallas_pruned"`` (two
    pruned passes a step); and ``knn_topk`` with its count on the device
    (``predicated_knn``). Returns the readings for the kernels line."""
    cfg = Config()
    torch.manual_seed(GRAPH_SEED)
    model = PointCloudDiffusionModel(cfg, device=dev)
    schedule = make_schedule(cfg).to(dev)
    encoder = model.net.style_encoder.encoder
    rng = np.random.default_rng(GRAPH_SEED)
    out = {"knn_topk_count": predicated_knn(dev, card)}

    def clouds(B):
        return torch.from_numpy(np.stack([
            normalize_point_cloud(make_cloud(rng, N_POINTS, dup_frac=0.0))[0]
            for _ in range(B)])).to(dev)

    for B in (1, 2):
        src, cond = clouds(B), clouds(B)
        gen = torch.Generator(device=dev).manual_seed(GRAPH_SEED + B)
        draws = dict(
            cond_priority=torch.rand((B, N_POINTS), generator=gen, device=dev),
            fps_starts=encoder.draw_fps_starts(M_POINTS, B, gen, dev),
            x_init=torch.randn((B, N_POINTS, 3), generator=gen, device=dev),
            step_priorities=torch.rand((STEPS, B, N_POINTS), generator=gen,
                                       device=dev))
        out[f"guided_B{B}"] = graph_run(
            f"guided_sample_loop B={B}", lambda: guided_sample_loop(
                model, schedule, src, cond, STEPS, GUIDANCE, **draws),
            GRAPH_LAUNCHES, card)
        if B == 1:  # the pruned kNN's backend on the same clouds and draws
            out["guided_pruned"] = graph_run(
                "guided_sample_loop B=1 pallas_pruned",
                lambda: guided_sample_loop(
                    model, schedule, src, cond, STEPS, GUIDANCE,
                    knn_backend="pallas_pruned", **draws),
                expect_counts(knn_pruned=2 * STEPS, fps=2, ball_query=2),
                card)
    src, cond = clouds(1), clouds(1)
    gen = torch.Generator(device=dev).manual_seed(GRAPH_SEED + 3)
    draws = dict(
        cond_priority=torch.rand((1, N_POINTS), generator=gen, device=dev),
        fps_starts=encoder.draw_fps_starts(M_POINTS, 1, gen, dev),
        src_priority=torch.rand((1, N_POINTS), generator=gen, device=dev),
        x_init=torch.randn((1, M_POINTS, 3), generator=gen, device=dev))
    out["fast"] = graph_run(
        "--fast (guided_sample_loop_coarse) B=1",
        lambda: guided_sample_loop_coarse(model, schedule, src, cond, STEPS,
                                          GUIDANCE, **draws),
        expect_counts(grid_topk=1, knn_topk=1, fps=2, ball_query=2), card)
    draws = dict(
        x_init=torch.randn((1, N_POINTS, 3), generator=gen, device=dev),
        cond_priorities=torch.rand((DDIM_STEPS, 1, N_POINTS), generator=gen,
                                   device=dev),
        fps_starts=torch.stack([encoder.draw_fps_starts(M_POINTS, 1, gen, dev)
                                for _ in range(DDIM_STEPS)]),
        step_priorities=torch.rand((DDIM_STEPS, 1, N_POINTS), generator=gen,
                                   device=dev))
    out["ddim"] = graph_run(
        f"ddim_sample_loop {DDIM_STEPS} steps B=1",
        lambda: ddim_sample_loop(model, schedule, src, cond, DDIM_STEPS,
                                 **draws),
        expect_counts(grid_interp=DDIM_STEPS, knn_topk=DDIM_STEPS,
                      fps=2 * DDIM_STEPS, ball_query=2 * DDIM_STEPS), card)
    return out


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
        n_cap = len(capture.CAPTURES)
        t0 = time.perf_counter()
        out = orig(self, sim, real, lr, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append(dict(
            ms=ms, counts=dict(LAUNCH_COUNTS), emit=bool(out[1]),
            captured=len(capture.CAPTURES) - n_cap,
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
    # the trainer's first mini-step runs eagerly, its second is captured
    # and replayed, the others replay; each counts the kernels the device
    # ran
    captures = [st["captured"] for st in steps]
    if captures != [0, 1, 0, 0, 0, 0]:
        fail(f"train: captures per mini-step {captures}")
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
    warm = ms[2:]  # replays
    print(f"[train] cli.train, Config() defaults ({cfg.total_points} points, "
          f"{cfg.global_points} coarse, feature_dim {cfg.feature_dim}, "
          f"{'bf16' if cfg.use_amp else 'float32'}, B={cfg.batch_size}, "
          f"accumulation {cfg.gradient_accumulation_steps}): 2 "
          f"epochs, 6 mini-steps, 2 optimizer steps, 2 validations, "
          f"checkpoints {ckpts}; {train_s:.2f} s in all; peak memory "
          f"{peak:.2f} GiB ({card})")
    print(f"[train] per mini-step: launches {TRAIN_STEP_LAUNCHES} each "
          f"(mini-step 1 eager, 2 captured and replayed, 3-6 replayed); "
          f"params/EMA moved after mini-steps "
          f"{[i + 1 for i, st in enumerate(steps) if st['params']]}; loss "
          f"terms {[{k: round(v, 5) for k, v in st['terms'].items()} for st in steps]}")
    print(f"[train] ms per mini-step (synchronised): "
          f"{', '.join(f'{t:.2f}' for t in ms)}; replays (3-6) mean "
          f"{np.mean(warm):.2f} ms (non-emitting "
          f"{np.mean([ms[i] for i in (3, 4)]):.2f}, emitting "
          f"{np.mean([ms[i] for i in (2, 5)]):.2f}); per optimizer step "
          f"(mini-steps 4-6, replays) {sum(ms[3:6]):.2f} ms")
    print(f"[train] resumed trainer: start epoch {resumed.start_epoch}, "
          "params, EMA and optimizer state identical")

    # one replayed mini-step of the resumed trainer under the profiler
    # (its first call runs eagerly, its second captures)
    batch = next(iter(create_dataloaders(cfg)[0]))
    sim = resumed._to_device(batch["sim_full"])
    real = resumed._to_device(batch["real_full"])
    for _ in range(2):
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
    print(f"[profile] one replayed training mini-step: wall {wall:.1f} ms "
          f"(profiled), "
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
    # a new engine: its loop runs eagerly in this call
    want = expect_counts(knn_topk=STEPS, fps=2, ball_query=2,
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
        unsafe = grid_knn.unsafe_counts()
    finally:
        cli_test.Tester.test, cli_test.earth_mover_distance = orig_test, \
            orig_emd
    if rc != 0 or len(testers) != 1:
        fail(f"test CLI: rc {rc}, {len(testers)} testers")
    # per direction: the grid one flat-batched pass and one counted patch
    # launch a step for the batch, the encoder's FPS and ball query once for
    # the batch; the first direction runs the loop eagerly, the second
    # captures and replays it, each counted once; the metrics: 14 row minima
    # (4 Chamfer x 2, Hausdorff 2 x 2, coverage 1 x 2) and one k=9 kNN per
    # uniformity
    n_clouds = 2 * TEST_BATCH
    patch_launches(unsafe, [TEST_BATCH] * 2 * STEPS)  # a count a cloud
    want = n_calls(expect_counts(grid_interp=STEPS, fps=2, ball_query=2,
                               knn_topk=STEPS), 2)
    want.update(rowmin=14, knn_topk=want["knn_topk"] + 2)
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
          f"launches {counts} ({sum(u > 0 for u in unsafe)} of "
          f"{len(unsafe)} clouds' grid steps with unsafe rows); "
          f"{tester.seconds:.3f} s per batch (Tester.test, "
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
    # an engine a checkpoint, each running its loop eagerly in its one call
    want = expect_counts(grid_interp=2 * STEPS, fps=4, ball_query=4,
                         knn_topk=2 * STEPS)
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
    # 2 warm-ups + 2 timed calls of each batch size: the first runs the
    # loop eagerly, the second captures and replays it, the others replay,
    # each counted once; the grid one pass and one counted patch launch a
    # step for each group of at most 8 clouds, one unsafe count a cloud
    groups = [g for s in samples for _ in range(4 * STEPS)
              for g in batch_groups(s["batch"])]
    patch_launches(grid_knn.unsafe_counts(), groups)
    passes = STEPS * sum(len(batch_groups(s["batch"])) for s in samples)
    want = n_calls(expect_counts(grid_interp=passes, knn_topk=passes,
                               fps=2 * len(samples),
                               ball_query=2 * len(samples)), 4)
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


# The training proof (examples/*_torch.py) at the JAX proof's settings and
# its bars, held to the JAX package's committed artifacts
PROOF_BUDGET_S = 120  # phase_proof at 4,096 points, after the build
JAX_PROOF = os.path.join(ROOT, "docs", "artifacts", "e2e_training")
JAX_PROOF_TESTS = ("test_20260817_144938", "test_20260818_134608",
                   "test_20260819_234928")
PROOF_BANDED = ("chamfer_sim_to_real", "chamfer_real_to_sim",
                "content_preservation", "emd_sim_to_real", "emd_real_to_sim")
LR_RTOL = 1e-3  # the rate an update applied against lr_for_epoch
SPIKE_BA_RTOL = 1e-3  # b/a against JAX's column (XLA's cumprod, 1.7e-6)
# graphs a proof run captures, by part: the train step, the eval step at
# B = 2 and at the ragged B = 1 (7 val pairs); cli.test's second direction
# (B = 4) in each run; fidelity's second call of each sampler (B = 1)
PROOF_CAPTURES = {"data": 0, "train": 3, "samples": 0, "test": 1,
                  "test_fast": 1, "spike": 0, "fidelity": 2}


def example(name: str):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_proof() -> dict:
    """The JAX proof's committed figures the bars are drawn from."""
    def load(*parts):
        with open(os.path.join(JAX_PROOF, *parts)) as f:
            return json.load(f)
    curve = load("loss_curve.json")
    tests = [load(d, "test_results.json")["average_metrics"]
             for d in JAX_PROOF_TESTS]
    return {"train_l1_last5": float(np.mean(curve["train_l1"][-5:])),
            "val_last": curve["val"][-1],
            "metric_keys": list(tests[-1]),
            "bands": {k: (0.5 * min(t[k] for t in tests),
                          1.5 * max(t[k] for t in tests))
                      for k in PROOF_BANDED},
            "spike": load("spike_analysis.json")["rows"]}


def proof_bars(res: dict, full: bool) -> list:
    """(bar, met, reading) in the order of the proof's bars; at 120,000
    points bars 1-3 against the run's own curve and bar 6's finiteness."""
    h, ref = res["history"], jax_proof()
    finite = lambda xs: bool(np.all(np.isfinite(xs)))  # noqa: E731
    l1_last5 = float(np.mean(h["train_l1"][-5:]))
    bars = [("1 finite", finite(h["train"] + h["train_l1"]
                                + h["train_chamfer"] + h["val"])
             and len(h["val"]) == 13 and sum(res["val_dropped"]) == 0,
             f"{len(h['train'])} epochs of train / train_l1 / train_chamfer "
             f"and {len(h['val'])} val readings finite, val batches dropped "
             f"{res['val_dropped']}"),
            ("2 train L1 own", l1_last5 <= 0.45 * h["train_l1"][0],
             f"mean of the last 5 epochs {l1_last5:.4f} <= 0.45 x epoch 0's "
             f"{h['train_l1'][0]:.4f}"),
            ("3 val own", h["val"][-1] <= 0.75 * max(h["val"]),
             f"val at epoch {h['val_epochs'][-1]} {h['val'][-1]:.4f} <= 0.75 "
             f"x the largest {max(h['val']):.4f}")]
    rows = res["spike"]["rows"]
    if full:
        return bars + [("6 spike finite", len(rows) == 21 and finite(
            [r[k] for r in rows for k in ("l1", "chamfer",
                                          "amplification_b_over_a")]),
            f"{len(rows)} rows finite")]
    lo, hi = 0.70 * ref["train_l1_last5"], 1.40 * ref["train_l1_last5"]
    bars.append(("2 train L1 vs JAX", lo <= l1_last5 <= hi,
                 f"{l1_last5:.4f} in [{lo:.4f}, {hi:.4f}] (0.70-1.40 x JAX's "
                 f"{ref['train_l1_last5']:.4f})"))
    lo, hi = 0.5 * ref["val_last"], 2.0 * ref["val_last"]
    bars.append(("3 val vs JAX", lo <= h["val"][-1] <= hi,
                 f"{h['val'][-1]:.4f} in [{lo:.4f}, {hi:.4f}] (0.5-2.0 x "
                 f"JAX's {ref['val_last']:.4f})"))
    for name in ("test", "test_fast"):
        got = res["tests"][name]["average_metrics"]
        bars.append((f"4 {name} keys", list(got) == ref["metric_keys"]
                     and finite(list(got.values())),
                     f"{len(got)} finite metrics under JAX's keys"))
        for k, (lo, hi) in ref["bands"].items():
            bars.append((f"4 {name} {k}", lo <= got[k] <= hi,
                         f"{got[k]:.4f} in [{lo:.4f}, {hi:.4f}]"))
    m = res["fidelity"]["mean"]
    scale = min(m["cd_parity_source"], m["cd_parity_style"])
    bars.append(("5 fidelity", m["cd_fast_parity"] <= 0.1 * scale,
                 f"mean CD(fast, parity) {m['cd_fast_parity']:.5f} <= 0.1 x "
                 f"{scale:.4f} (ratio {m['cd_fast_parity'] / scale:.4f}; "
                 f"JAX 0.0053 / 0.60)"))
    by_t = {r["t"]: r for r in rows}
    ba_err = max(abs(r["amplification_b_over_a"] - w["amplification_b_over_a"])
                 / w["amplification_b_over_a"]
                 for r, w in zip(rows, ref["spike"])) if len(rows) == len(
                     ref["spike"]) else float("inf")
    bars += [("6 spike rows", [r["t"] for r in rows]
              == [w["t"] for w in ref["spike"]], f"{len(rows)} rows"),
             ("6 spike L1", all(0.05 <= r["l1"] <= 2.0 for r in rows),
              f"L1 {min(r['l1'] for r in rows):.4f}-"
              f"{max(r['l1'] for r in rows):.4f} in [0.05, 2.0]"),
             ("6 spike Chamfer", by_t[999]["chamfer"]
              >= 100 * by_t[500]["chamfer"],
              f"t=999 {by_t[999]['chamfer']:.4g} >= 100 x t=500 "
              f"{by_t[500]['chamfer']:.4g}"),
             ("6 spike b/a", ba_err <= SPIKE_BA_RTOL,
              f"b/a within {ba_err:.3g} of JAX's column (rtol "
              f"{SPIKE_BA_RTOL})")]
    return bars


def phase_proof(dev: torch.device, card: str, full: bool = False) -> dict:
    """``examples/e2e_training_proof_torch.py`` at the JAX proof's settings
    (64 synthetic LiDAR pairs, 4,096 points, 1,024 coarse; with ``full``
    ``Config()``'s 120,000 / 30,000), then ``loss_spike_analysis_torch.py``
    and ``fast_mode_fidelity_torch.py`` on its ``best_model``: the launch
    counts set to 0 just before and read just after; the seconds, ms per
    replayed mini-step, captures, peak memory and learning-rate trace
    printed; each artifact printed as a line; then the bars, the run
    failing at the first missed. Returns the readings and launches."""
    tag = "[proof_full]" if full else "[proof]"
    capture.release()  # the earlier phases' graphs
    proof, spike_mod, fid_mod = (example(f"{n}_torch") for n in (
        "e2e_training_proof", "loss_spike_analysis", "fast_mode_fidelity"))
    size = ["--points", str(N_POINTS), "--global_points", str(M_POINTS)] \
        if full else []
    with tempfile.TemporaryDirectory() as work:
        wd, out = os.path.join(work, "proof"), os.path.join(work, "out")
        reset_launch_counts()
        t0 = time.perf_counter()
        res = proof.main(["--workdir", wd, "--outdir", out,
                          "--device", dev.type, *size])
        for name, run, argv in (
                ("spike", spike_mod.main,
                 ["--checkpoint", res["best_model"], "--data",
                  os.path.join(res["processed"], "val")]),
                ("fidelity", fid_mod.main, ["--workdir", wd])):
            before = len(capture.CAPTURES)
            ts = time.perf_counter()
            res[name] = run([*argv, "--outdir", out, "--device", dev.type])
            res["peak_mib"][name] = proof.peak_mib(dev)
            res["seconds"][name] = time.perf_counter() - ts
            res["captures"][name] = len(capture.CAPTURES) - before
        seconds = time.perf_counter() - t0
        counts = dict(LAUNCH_COUNTS)
        artifacts = proof.artifact_lines(out, npy=not full)
    h = res["history"]
    per_epoch = res["mini_steps"] // len(h["train"])
    step_ms = 1e3 * float(np.median(res["epoch_seconds"][1:])) / per_epoch
    in_step_ms = 1e3 * float(np.median(res["step_seconds"][1:])) / per_epoch
    print(f"{tag} e2e_training_proof_torch + loss_spike_analysis_torch + "
          f"fast_mode_fidelity_torch, {size[1] if full else 4096} points / "
          f"{size[3] if full else 1024} coarse, 64 pairs, "
          f"{len(h['train'])} epochs at batch 2, {res['mini_steps']} "
          f"mini-steps: {seconds:.1f} s in all; by part "
          + ", ".join(f"{k} {v:.1f} s" for k, v in res["seconds"].items())
          + f"; {step_ms:.2f} ms per replayed mini-step (the median epoch "
          f"after the first, host clock with loading, / {per_epoch}), of "
          f"which {in_step_ms:.2f} ms inside train_step (draws, key, input "
          f"copies, the replay's launch) and the rest the loader's and the "
          f"batches' copies; epoch 0 {res['epoch_seconds'][0]:.2f} s (eager "
          f"and captured steps) ({card})")
    print(f"{tag} captures by part {res['captures']}, "
          f"{sum(res['captures'].values())} in all; peak memory MiB "
          + json.dumps({k: v and round(v, 1)
                        for k, v in res["peak_mib"].items()})
          + " (capture.release() after training)")
    print(f"{tag} learning rate by epoch (lr_for_epoch, the rate one update "
          "applied, recovered from the parameters and moments, the update's "
          "rms): " + json.dumps([[r["epoch"], r["lr_for_epoch"],
                                  r["applied"], r["update_rms"]]
                                 for r in res["lr"]]))
    print(f"{tag} curve: train_l1 {h['train_l1'][0]:.4f} -> mean of the last "
          f"5 {np.mean(h['train_l1'][-5:]):.4f}; train total "
          f"{min(h['train']):.4g}-{max(h['train']):.4g}; val "
          + json.dumps(dict(zip(h["val_epochs"],
                                [round(v, 4) for v in h["val"]])))
          + f"; val batches dropped {res['val_dropped']}")
    print(f"{tag} launches {counts}")
    for line in artifacts:
        print(line.replace("[proof]", tag, 1))
    lr_bad = [r for r in res["lr"]
              if abs(r["applied"] / r["lr_for_epoch"] - 1) > LR_RTOL]
    if len(res["lr"]) != len(h["train"]) or lr_bad:
        fail(f"{tag} the rate applied differs from lr_for_epoch beyond "
             f"{LR_RTOL}: {lr_bad}")
    if res["captures"] != PROOF_CAPTURES:
        fail(f"{tag} captures {res['captures']} != {PROOF_CAPTURES}")
    used = ("knn_topk", "fps", "ball_query", "rowmin") + (
        ("grid_interp", "grid_topk") if full else ())
    if any(counts[name] == 0 for name in used):
        fail(f"{tag} a kernel of the path never launched: {counts}")
    for bar, met, reading in proof_bars(res, full):
        print(f"{tag} bar {bar}: {reading}: {'met' if met else 'MISSED'}")
        if not met:
            fail(f"{tag} bar {bar} missed: {reading}")
    if not full and seconds > PROOF_BUDGET_S:
        fail(f"{tag} {seconds:.1f} s, over the {PROOF_BUDGET_S} s budget")
    return {"seconds": seconds, "step_ms": step_ms, "in_step_ms": in_step_ms,
            "captures": res["captures"], "launches": counts}


# The repo's profiling, probe and demo scripts on the port
# (examples/*_torch.py) at Config() width
TOOLS_BUDGET_S = 180  # phase_tools, after the build
TOOLS = ("profile_sampler_step_torch", "profile_sampler_step_batched_torch",
         "profile_interp_stages_torch", "profile_style_encoder_torch",
         "profile_voxel_batch_torch", "profile_train_batch_scaling_torch",
         "profile_batched_sampler_torch", "probe_sampler_unsafe_torch",
         "demo_synthetic_torch")


def tool_run(name: str, argv: list) -> tuple[dict, float]:
    """``examples/<name>.py``'s ``main(argv)`` on the card, its standard
    output printed again line by line under ``[tools] <name>:``: (its
    result, its seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = example(name).main([*argv, "--device", "cuda"])
    finally:
        for line in buf.getvalue().splitlines():
            if line.strip():
                print(f"[tools] {name}: {line}")
    seconds = time.perf_counter() - t0
    print(f"[tools] {name}: {seconds:.1f} s")
    return res, seconds


def phase_tools(dev: torch.device, card: str) -> dict:
    """The nine scripts of ``TOOLS`` in turn through their ``main``, each
    at its defaults (``Config()``: 120,000 / 30,000 points, bf16, the
    grid), the demo in a directory of its own: the launch counts set to 0
    just before and read just after; the sampler step's ``full`` body
    held identical to ``samplers._guided_body`` on the card and each
    variant's launches to what it stubs (the script's own checks, read
    again here); every kernel of the scripts' paths launched; within
    ``TOOLS_BUDGET_S``. Returns the readings and launches."""
    capture.release()  # the earlier phases' graphs
    reset_launch_counts()
    t0 = time.perf_counter()
    res, by_script = {}, {}
    with tempfile.TemporaryDirectory() as work:
        for name in TOOLS:
            argv = ["--workdir", os.path.join(work, "demo")] \
                if name == "demo_synthetic_torch" else []
            res[name], by_script[name] = tool_run(name, argv)
    seconds = time.perf_counter() - t0
    counts = dict(LAUNCH_COUNTS)
    step_tool = example("profile_sampler_step_torch")
    step = res["profile_sampler_step_torch"]
    if step["full_equals_guided_body"] is not True:
        fail("[tools] the sampler step's full body differs from "
             "_guided_body")
    for variant, r in step["variants"].items():
        if r["launches_per_step"] != step_tool.LAUNCHES[variant]:
            fail(f"[tools] {variant} launched {r['launches_per_step']} a "
                 f"step != {step_tool.LAUNCHES[variant]}")
    if not res["demo_synthetic_torch"]["finite"]:
        fail("[tools] the demo's transferred cloud or metrics not finite")
    used = ("grid_interp", "knn_topk", "fps", "ball_query", "rowmin")
    if any(counts[name] == 0 for name in used):
        fail(f"[tools] a kernel of the scripts' paths never launched: "
             f"{counts}")
    full = step["variants"]["full"]["ms_per_step"]
    print(f"[tools] sampler step at Config(): full {full:.4f} ms a step; "
          "marginals (None: unresolved) " + json.dumps({
              v: round(m["ms"], 4) if m["resolved"] else None
              for v, m in ((v, r["marginal"]) for v, r in
                           step["variants"].items()) if m is not None})
          + f"; replayed full step busy "
          f"{100 * step['profile']['busy_share']:.1f}%; points/s by B "
          + json.dumps({mode: {B: round(r["points_per_s"]) for B, r in
                               by_b.items()} for mode, by_b in
                        res["profile_batched_sampler_torch"]["by_mode"]
                        .items()})
          + f"; unsafe rows a step {res['probe_sampler_unsafe_torch']['unsafe']}")
    print(f"[tools] {len(TOOLS)} scripts in {seconds:.1f} s (budget "
          f"{TOOLS_BUDGET_S} s); launches {counts} ({card})")
    if seconds > TOOLS_BUDGET_S:
        fail(f"[tools] {seconds:.1f} s, over the {TOOLS_BUDGET_S} s budget")
    return {"seconds": seconds, "launches": counts, "by_script": by_script}


PARALLEL_SEED = 30


def acc_grads_err(a: DiffusionTrainer, b: DiffusionTrainer) -> dict:
    """The largest difference of two trainers' accumulated gradients by
    part, over the train reference's bar for the part (``grad_gaps``)."""
    names = a.optimizer.names
    return grad_gaps(
        dict(zip(names, a.optimizer.acc_grads.split(a.optimizer.sizes))),
        dict(zip(names, b.optimizer.acc_grads.split(b.optimizer.sizes))))


def grad_gaps(got: dict, want: dict) -> dict:
    """The largest difference of two sets of gradient-like tensors (by
    parameter name) by part, over the train reference's bar for the part:
    ``GRAD_RTOL`` of each tensor's largest |g|, and for a pre-BN bias (zero
    in exact arithmetic) ``PRE_BN_BIAS_RATIO`` of its weight's largest
    |g|. 1.0 is the bar."""
    worst = {}
    for name in want:
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


TRAIN_GRAPH_SEED = 50
TRAIN_LR = 1e-4
# an eval step's launches (no Chamfer: the style encoder's FPS and ball
# query)
EVAL_STEP_LAUNCHES = expect_counts(fps=2, ball_query=2)


def eager_steps(trainer: DiffusionTrainer) -> DiffusionTrainer:
    """``trainer`` with its steps run eagerly on the card (the capture
    runner bypassed): the reference the captured steps are held to."""
    trainer._graphed = lambda draws: False
    return trainer


def trainer_state(t: DiffusionTrainer) -> dict:
    """What the steps leave, by parameter name: the parameters, the EMA,
    the optimizer's accumulator and moments (the second as its square
    root, which errs like a gradient)."""
    opt = t.optimizer

    def named(flat):
        return dict(zip(opt.names, flat.clone().split(opt.sizes)))
    return {"params": {k: p.detach().clone() for k, p in t.params.items()},
            "ema": {k: e.clone() for k, e in t.ema_params.items()},
            "acc_grads": named(opt.acc_grads), "mu": named(opt.mu),
            "sqrt_nu": named(opt.nu.sqrt())}


def state_gaps(got: dict, want: dict, updates: int) -> dict:
    """Two trainers' states after the same mini-steps, each gap over its
    bar (1.0 is the bar): the accumulator (when not just reset) and the
    moments (after an optimizer step) at ``grad_gaps``' bars; parameters
    within 2.2 lr an optimizer step (Adam's early steps move a weight by
    about lr * sign(g), and a gradient of rounding noise, a pre-BN bias's,
    may differ in sign), the EMA within (1 - decay) of that plus 2.5e-7
    relative."""
    gaps = {}
    if any(v.any() for v in want["acc_grads"].values()):
        gaps.update({f"acc_grads {k}": v for k, v in grad_gaps(
            got["acc_grads"], want["acc_grads"]).items()})
    if updates:
        for key in ("mu", "sqrt_nu"):
            gaps.update({f"{key} {k}": v for k, v in grad_gaps(
                got[key], want[key]).items()})
    bar = max(updates, 1) * 2.2 * TRAIN_LR
    gaps["params"] = max(float((got["params"][k] - want["params"][k])
                               .abs().max()) for k in want["params"]) / bar
    gaps["ema"] = max(float(((got["ema"][k] - want["ema"][k]).abs()
                             / (1e-3 * bar + 2.5e-7 * want["ema"][k].abs()))
                            .max()) for k in want["ema"])
    return gaps


def step_call(fn, want: dict, what: str, check: bool = False):
    """(fn's result, host ms to a device sync), its launches (set to 0 just
    before, read just after) held to ``want``; with ``check`` the call runs
    under ``set_sync_debug_mode("error")``."""
    reset_launch_counts()
    torch.cuda.synchronize()
    if check:
        torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        out = fn()
    except RuntimeError as e:
        if check:
            fail(f"[train graph] {what}: the eager body synchronised: {e}")
        raise
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if dict(LAUNCH_COUNTS) != want:
        fail(f"[train graph] {what}: launches {dict(LAUNCH_COUNTS)} != "
             f"{want}")
    return out, ms


def phase_train_graph(dev: torch.device, card: str) -> dict:
    """``DiffusionTrainer.train_step`` and ``.eval_step`` as captured
    programs (``models.capture``, cache "step"). In float32 at ``Config()``
    width (the bars are float32's), three trainers from one seed on the
    same batches: two eager (the capture runner bypassed), the second's
    first mini-step and first eval step under
    ``set_sync_debug_mode("error")``, and one through the runner (first
    call eager, second captured, later replayed), 6 mini-steps and 2 eval
    steps each: the first mini-step's loss terms identical, every loss term
    within 1e-5, the emit pattern F, F, T, F, F, T, launches set to 0 just
    before each call and read just after (``TRAIN_STEP_LAUNCHES`` /
    ``EVAL_STEP_LAUNCHES`` each), the states after every mini-step within
    ``state_gaps``' bars of the eager one's, the two eager runs' own gaps
    printed beside them. Then at ``Config()`` (bf16) an eager and a
    captured trainer in turns over 9 mini-steps and 5 eval steps: ms of
    each call (first, captured, replays), per optimizer step, the graphs'
    memory, and a profiled eager and replayed mini-step (device busy
    share, the port's kernels). After the first optimizer step the first
    eager trainer's state is loaded into the other two (``load_state``,
    in place): a rounding-noise gradient's sign moves its weight by about
    lr either way, which would part the runs past the bars, and the
    captured graph must then read the loaded state. Returns the replay's
    launches."""
    rng = np.random.default_rng(TRAIN_GRAPH_SEED)

    def batches(n, B):
        return [tuple(torch.from_numpy(np.stack([normalize_point_cloud(
            make_cloud(rng, N_POINTS))[0] for _ in range(B)])).to(dev)
            for _ in range(2)) for _ in range(n)]

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in (
            "checkpoint_dir", "log_dir", "result_dir")}
        cfg = Config(**dirs, experiment_name="train_graph", use_amp=False)
        ref, again, graphed = (DiffusionTrainer(cfg, resume=False,
                                                device=dev) for _ in range(3))
        eager_steps(ref)
        eager_steps(again)
        data = batches(6, cfg.batch_size)
        n_cap = len(capture.CAPTURES)
        terms, emits, steps = [], [], []
        for i, (sim, real) in enumerate(data):
            if i == 3:
                # the first optimizer step's sign noise (a rounding-noise
                # gradient moves its weight by about +-lr) would part the
                # runs from here on: the eager run's state is copied into
                # the others in place, so the second cycle starts alike
                # and the captured graph must read what was loaded
                state = ref.state()
                for t in (again, graphed):
                    t.load_state(state)
            row = []
            for t, name in ((ref, "eager"), (again, "eager again"),
                            (graphed, "captured")):
                (ld, emit), _ = step_call(
                    lambda: t.train_step(sim, real, TRAIN_LR),
                    TRAIN_STEP_LAUNCHES, f"{name} mini-step {i + 1}",
                    check=t is again and i == 0)
                row.append(({k: float(v) for k, v in ld.items()},
                            bool(emit)))
            terms.append([r[0] for r in row])
            emits.append([r[1] for r in row])
            updates = (i + 1) // 3
            want = trainer_state(ref)
            # (captured, eager again) vs eager: loss terms, states
            steps.append(tuple(
                (max(abs(row[j][0][k] / row[0][0][k] - 1)
                     for k in row[0][0]),
                 state_gaps(trainer_state(t), want, updates))
                for j, t in ((2, graphed), (1, again))))
        if len(capture.CAPTURES) != n_cap + 1:
            fail(f"[train graph] {len(capture.CAPTURES) - n_cap} captures "
                 "in 6 mini-steps (one expected, at the second)")
        pattern = [False, False, True, False, False, True]
        if any(e != [p] * 3 for e, p in zip(emits, pattern)):
            fail(f"[train graph] emit per mini-step {emits}")
        if len(set(map(repr, terms[0]))) != 1:
            fail(f"[train graph] first mini-step's loss terms differ: "
                 f"{terms[0]}")
        evals = []
        for i, (sim, real) in enumerate(data[:2]):
            row = []
            for t, name in ((ref, "eager"), (again, "eager again"),
                            (graphed, "captured")):
                ld, _ = step_call(lambda: t.eval_step(sim, real),
                                  EVAL_STEP_LAUNCHES,
                                  f"{name} eval step {i + 1}",
                                  check=t is again and i == 0)
                row.append(float(ld["total_loss"]))
            evals.append(row)
        eval_gaps = [max(abs(r[j] / r[0] - 1) for r in evals) for j in (2, 1)]
        if len(capture.CAPTURES) != n_cap + 2:
            fail(f"[train graph] {len(capture.CAPTURES) - n_cap} captures "
                 "after the eval steps (two expected)")

        def fmt(gaps):
            return ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        print(f"[train graph] float32, Config() width ({N_POINTS} / "
              f"{M_POINTS} points, B={cfg.batch_size}, accumulation "
              f"{cfg.gradient_accumulation_steps}): 6 mini-steps and 2 eval "
              f"steps, captured (first call eager, second captured, then "
              f"replays) and a second eager run vs eager on the same draws: "
              f"first mini-step's loss terms identical {terms[0][0]}; emit "
              f"{[e[2] for e in emits]}; launches "
              f"{ {k: v for k, v in TRAIN_STEP_LAUNCHES.items() if v} } a "
              f"mini-step, { {k: v for k, v in EVAL_STEP_LAUNCHES.items() if v} }"
              f" an eval step; no sync in the eager bodies "
              f"(set_sync_debug_mode 'error') ({card})")
        for i, ((loss_c, gaps_c), (loss_e, gaps_e)) in enumerate(steps):
            print(f"[train graph] mini-step {i + 1}: loss terms captured "
                  f"{loss_c:.3g} / eager again {loss_e:.3g} relative; gaps "
                  f"over their bars (1 is the bar), captured: {fmt(gaps_c)}")
            print(f"[train graph] mini-step {i + 1}: eager again: "
                  f"{fmt(gaps_e)}")
        print(f"[train graph] eval steps: total loss captured "
              f"{eval_gaps[0]:.3g} / eager again {eval_gaps[1]:.3g} relative "
              f"{evals}")
        worst = max(max(g.values()) for (_, g), _ in steps)
        loss_gap = max(loss for (loss, _), _ in steps)
        if loss_gap > 1e-5 or worst > 1.0 or eval_gaps[0] > 1e-5:
            fail(f"[train graph] captured vs eager over its bars: loss "
                 f"{loss_gap:.3g}, eval {eval_gaps[0]:.3g} (bars 1e-5), "
                 f"worst gap {worst:.3g}")
        out["float32"] = {"steps": steps, "eval_gaps": eval_gaps}
        del ref, again, graphed
        torch.cuda.empty_cache()

        # timing at Config(): bf16, as cli.train runs
        cfg = Config(**dirs, experiment_name="train_graph_bf16")
        eager, graphed = (DiffusionTrainer(cfg, resume=False, device=dev)
                          for _ in range(2))
        eager_steps(eager)
        data = batches(3, cfg.batch_size)
        ms = {"eager": [], "captured": []}
        pools = {}
        for i in range(9):
            sim, real = data[i % 3]
            for t, name in ((eager, "eager"), (graphed, "captured")):
                if t is graphed and i == 1:
                    torch.cuda.empty_cache()
                    reserved = torch.cuda.memory_reserved()
                _, t_ms = step_call(
                    lambda: t.train_step(sim, real, TRAIN_LR),
                    TRAIN_STEP_LAUNCHES, f"bf16 {name} mini-step {i + 1}")
                ms[name].append(t_ms)
                if t is graphed and i == 1:
                    pools["train"] = (torch.cuda.memory_reserved()
                                      - reserved) / 2**30
        eval_ms = {"eager": [], "captured": []}
        for i in range(5):
            sim, real = data[i % 3]
            for t, name in ((eager, "eager"), (graphed, "captured")):
                if t is graphed and i == 1:
                    torch.cuda.empty_cache()
                    reserved = torch.cuda.memory_reserved()
                _, t_ms = step_call(lambda: t.eval_step(sim, real),
                                    EVAL_STEP_LAUNCHES,
                                    f"bf16 {name} eval step {i + 1}")
                eval_ms[name].append(t_ms)
                if t is graphed and i == 1:
                    pools["eval"] = (torch.cuda.memory_reserved()
                                     - reserved) / 2**30
        caps = [c["capture_s"] * 1e3 for c in capture.CAPTURES[-2:]]
        sim, real = data[0]
        profiles = {}
        for t, name in ((eager, "eager"), (graphed, "replayed")):
            reset_launch_counts()
            _, launches, n_all, busy, wall = profiled_replay(
                lambda: t.train_step(sim, real, TRAIN_LR),
                TRAIN_STEP_LAUNCHES)
            if launches != TRAIN_STEP_LAUNCHES:
                fail(f"[train graph] a profiled {name} mini-step ran "
                     f"{launches}")
            profiles[name] = (wall, busy, n_all, launches)
        opt_step = {k: sum(v[6:9]) for k, v in ms.items()}
        replay = ms["captured"][2:]
        print(f"[train graph] Config() (bf16, B={cfg.batch_size}), ms per "
              f"mini-step, eager: {', '.join(f'{t:.2f}' for t in ms['eager'])}"
              f"; captured: first call (eager) {ms['captured'][0]:.2f}, "
              f"second {ms['captured'][1]:.2f} (capture + instantiate "
              f"{caps[0]:.1f}, then a replay), replays "
              f"{', '.join(f'{t:.2f}' for t in replay)} (mean "
              f"{np.mean(replay):.2f}, best {min(replay):.2f}); per optimizer "
              f"step (mini-steps 7-9): eager {opt_step['eager']:.2f}, "
              f"replayed {opt_step['captured']:.2f} ({card})")
        print(f"[train graph] Config() eval step ms, eager: "
              f"{', '.join(f'{t:.2f}' for t in eval_ms['eager'])}; captured: "
              f"first {eval_ms['captured'][0]:.2f}, second "
              f"{eval_ms['captured'][1]:.2f} (capture + instantiate "
              f"{caps[1]:.1f}), replays "
              f"{', '.join(f'{t:.2f}' for t in eval_ms['captured'][2:])}; "
              f"graph memory (reserved growth at the capture): train "
              f"{pools['train']:.3f} GiB, eval {pools['eval']:.3f} GiB "
              f"(the B = 1 sampler's: 0.40 GiB) ({card})")
        for name, (wall, busy, n_all, launches) in profiles.items():
            print(f"[train graph] profiled {name} mini-step: wall "
                  f"{wall:.2f} ms, device busy {busy:.2f} ms "
                  f"({100 * busy / wall:.1f}%), {n_all} device kernels and "
                  f"copies, the port's "
                  f"{ {k: v for k, v in launches.items() if v} }")
        out.update(ms=ms, eval_ms=eval_ms, capture_ms=caps, pool_gib=pools,
                   opt_step_ms=opt_step,
                   busy_share={k: v[1] / v[0] for k, v in profiles.items()},
                   launches=profiles["replayed"][3])
    return out


class _Owner:
    """What the ``[parallel graph]`` graphs read (the runner keeps a weak
    reference to it)."""


def collective_bodies(group, dev: torch.device) -> dict:
    """Each collective the meshed paths run, alone, as a body for the
    capture runner and a maker of its inputs (new draws a call), at the
    shapes of a ``Config()`` run on ``group``'s n ranks: name -> (body,
    make inputs)."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.parallel.mesh import (
        AllGather, AllReduceSum, all_gather)
    n = dist.get_world_size(group)
    cfg = Config()
    n_params = sum(p.numel() for p in DiffusionNet(
        cfg.feature_dim, cfg.time_embed_dim).parameters())
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 1)
    u, m = (N_POINTS - M_POINTS) // n, M_POINTS // n

    def randn(*shape):
        return lambda: {"x": torch.randn(shape, generator=gen, device=dev)}

    def with_grad(*shapes):
        return lambda: {k: torch.randn(s, generator=gen, device=dev)
                        for k, s in zip(("x", "g"), shapes)}

    def gather_fwd(ins):
        with torch.no_grad():
            return AllGather.apply(ins["x"], group, 1)

    def gather_bwd(ins):
        x = ins["x"].detach().requires_grad_()
        return torch.autograd.grad(AllGather.apply(x, group, 1), x,
                                   ins["g"])[0]

    def reduce_fwd(ins):
        with torch.no_grad():
            return AllReduceSum.apply(ins["x"], group)

    def reduce_bwd(ins):
        x = ins["x"].detach().requires_grad_()
        return torch.autograd.grad(AllReduceSum.apply(x, group), x,
                                   ins["g"])[0]

    def flat_grads(ins):
        flat = ins["x"].clone()
        dist.all_reduce(flat, group=group)
        return flat

    return {
        # the sampler's shares of the unknown points' noise, gathered
        "mesh.all_gather [1, U/n, 3]": (
            lambda ins: all_gather(ins["x"], group, 1), randn(1, u, 3)),
        # the point-sharded denoiser's rows, forward and backward
        "AllGather forward [1, M/n, 3]": (gather_fwd, randn(1, m, 3)),
        "AllGather backward [1, M/n, 3]": (gather_bwd,
                                           with_grad((1, m, 3), (1, M_POINTS,
                                                                 3))),
        # BatchNorm's sums over the data ranks, forward and backward
        "AllReduceSum forward [2, 512]": (reduce_fwd, randn(2, 512)),
        "AllReduceSum backward [2, 512]": (reduce_bwd,
                                           with_grad((2, 512), (2, 512))),
        # StepLayout.mean_grads: the flat gradient buffer
        f"dist.all_reduce [{n_params}]": (flat_grads, randn(n_params))}


def replay_events(graph, groups=()) -> list:
    """The device events (name, count) of one replay of ``graph`` (a
    ``CUDAGraph``) under the profiler. A trace that holds none is taken
    again, at most twice, and noted on stderr: the card's tracer has
    dropped a replay's copies (an in-place one-rank all-reduce has
    none). A graph of collectives on ``groups`` is retaken on every rank
    of them or on none (``capture.agree``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        events = [(e.key, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if capture.agree(groups, int(bool(events))):
            break
        print(f"replay_events: no device event traced (trace {attempt + 1} "
              f"of at most 3)", file=sys.stderr)
    return events


def phase_parallel_graph(dev: torch.device, card: str, group) -> dict:
    """``[parallel graph]``: each collective of the meshed paths alone
    (``collective_bodies``) through ``run_captured(groups=[group])``: its
    first call eager, its second captured (one capture) and replayed, then
    3 replays on new inputs, each identical to the body run eagerly on the
    same inputs; one replay under the profiler, its device events by name.
    On one rank NCCL enqueues no kernel (an all-gather is a device copy,
    an in-place all-reduce nothing); on n > 1 ranks each replay must hold
    an NCCL kernel. And the ranks' agreement on a call's branch
    (``capture.agree``): host microseconds a call."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    owner = _Owner()
    out = {}
    for name, (body, make) in collective_bodies(group, dev).items():
        key = ("parallel graph", name)
        n_cap = len(capture.CAPTURES)
        gap = 0.0
        for call in range(5):  # eager, captured + replayed, 3 replays
            ins = make()
            got = capture.run_captured(key, body, ins, owner,
                                       cache="parallel", groups=[group])
            want = body(ins)
            if not torch.equal(got, want):
                # on n > 1 ranks a sum may take another order: noted
                gap = max(gap, float((got - want).abs().max()
                                     / want.abs().max()))
                if n == 1 or gap > 1e-6:
                    fail(f"[parallel graph] {name}: call {call + 1} differs "
                         f"from the eager body ({gap:.3g} of its largest "
                         f"value)")
            if len(capture.CAPTURES) - n_cap != (call > 0):
                fail(f"[parallel graph] {name}: "
                     f"{len(capture.CAPTURES) - n_cap} captures after call "
                     f"{call + 1}")
        graph = capture._ENTRIES["parallel"][next(reversed(
            capture._ENTRIES["parallel"]))].graph.graph
        events = replay_events(graph, [group] if n > 1 else ())
        nccl = sum(c for k, c in events if "nccl" in k.lower())
        if n > 1 and not nccl:
            fail(f"[parallel graph] {name}: no NCCL kernel in a replay on "
                 f"{n} ranks: {events}")
        out[name] = {"replay_events": events, "nccl_kernels": nccl,
                     "gap": gap}
        same = ("each identical to the eager body" if not gap else
                f"within {gap:.3g} of the eager body's largest value")
        print(f"[parallel graph] {name} on {n} rank(s): eager first call, "
              f"captured second, 3 replays on new inputs, {same}; a replay's "
              f"device events {events} ({card})")
    times = []
    for _ in range(51):
        t0 = time.perf_counter()
        capture.agree([group], capture.REPLAY)
        times.append(time.perf_counter() - t0)
    out["agree_us"] = 1e6 * float(np.median(times[1:]))
    print(f"[parallel graph] the ranks' agreement on a call's branch "
          f"(capture.agree, one all-reduce of an int and its read-back) on "
          f"{n} rank(s): median {out['agree_us']:.1f} us over 50 calls "
          f"(min {1e6 * min(times[1:]):.1f}) ({card})")
    return out


def timed(fn) -> tuple:
    """(fn's result, host seconds to a device sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_parallel(dev: torch.device, card: str) -> dict:
    """``parallel/`` on a one-rank NCCL group on the card (NCCL puts no two
    ranks on one GPU and this machine has one), at full width: the ring row
    minimum, kNN and evaluation Chamfer at 120,000 x 120,000, the
    point-sharded and the data-parallel sampler at 120,000 / 30,000 points
    and 50 steps, each through the capture runner, and
    ``DiffusionTrainer(mesh_shape={"data": 1})``'s captured steps, each
    against its single-device path on the same inputs and draws, launch
    counts set to 0 just before each run and read just after; then
    ``[parallel graph]``. Returns each kernel's launches by path."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.ops import chamfer_distance_l2
    from pointcloud_style_transfer_torch.parallel import (
        guided_sample_loop_dp, guided_sample_loop_sharded, make_mesh,
        ring_min_sq_dist)
    from pointcloud_style_transfer_torch.parallel.mesh import axis_group
    from pointcloud_style_transfer_torch.parallel.ring import (
        ring_chamfer_distance_l2, ring_knn)

    rng = np.random.default_rng(PARALLEL_SEED)
    points = make_mesh({"points": 1}, "cuda")
    data = make_mesh({"data": 1}, "cuda")
    print(f"[parallel] one-rank {dist.get_backend()} group, meshes "
          f"{points} and {data}; {library_versions()}; multi-card runs: "
          f"`chip_smoke.py --ranks n`, this machine has "
          f"{torch.cuda.device_count()} card ({card})")
    launches = {}

    def counted(path: str, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        out, s = timed(fn)
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
              f"(dense {dense_ms:.3f} ms), eager by design ({card})")

    cfg = Config()
    torch.manual_seed(PARALLEL_SEED)
    net = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim,
                       compute_dtype=dtype_of(cfg))
    model = PointCloudDiffusionModel(cfg, dev, net=net)
    schedule = make_schedule(cfg).to(dev)
    src, cond = (torch.from_numpy(normalize_point_cloud(
        make_cloud(rng, N_POINTS, dup_frac=0.0))[0])[None].to(dev)
        for _ in range(2))
    draws = sampler_draws(torch.Generator(device=dev).manual_seed(
        PARALLEL_SEED), dev)
    run = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, **draws)
    paths = (
        ("guided_sample_loop", lambda: guided_sample_loop(
            model, schedule, src, cond, **run)),
        ("guided_sample_loop_sharded", lambda: guided_sample_loop_sharded(
            model, schedule, src, cond, points, **run)),
        ("guided_sample_loop_dp", lambda: guided_sample_loop_dp(
            model, schedule, src, cond, data, STEPS, GUIDANCE,
            draws=[draws])))
    with eager_samplers():  # the point-sharded body run eagerly
        sharded_eager = guided_sample_loop_sharded(model, schedule, src, cond,
                                                   points, **run)
    # each path through the capture runner, in turns (a, b, c, c, b, a,
    # a, b, c, c, b, a): the single-device and data-parallel samplers
    # share one key (a: eager, c: captured and replayed, then replays),
    # the point-sharded one has its own, its mesh's (eager, captured,
    # replays); each run's launches, counted where the device runs them,
    # are the single-device sampler's
    single = {k: v for k, v in GRAPH_LAUNCHES.items() if v}
    outs, firsts, secs, caps = {}, {}, {}, {}
    for path, fn in (paths + paths[::-1]) * 2:
        n_cap = len(capture.CAPTURES)
        outs[path], s = counted(path, fn)
        firsts.setdefault(path, outs[path])
        secs.setdefault(path, []).append(s)
        caps.setdefault(path, []).append(len(capture.CAPTURES) - n_cap)
        if launches[path] != single:
            fail(f"[parallel] {path} run {len(secs[path])} launches "
                 f"{launches[path]} != {single}")
        if not torch.equal(firsts[path], outs[path]):
            fail(f"[parallel] run {len(secs[path])} of {path} differs from "
                 f"its first on the same inputs")
    if caps["guided_sample_loop_sharded"] != [0, 1, 0, 0]:
        fail(f"[parallel] the point-sharded sampler's captures a call "
             f"{caps['guided_sample_loop_sharded']} (0, 1, 0, 0 expected)")
    if not torch.equal(sharded_eager, outs["guided_sample_loop_sharded"]):
        fail("[parallel] the captured point-sharded sampler differs from its "
             "eager body")
    for path, _ in paths[1:]:
        if not torch.equal(outs[path], outs["guided_sample_loop"]):
            err = float((outs[path] - outs["guided_sample_loop"]).abs().max())
            fail(f"[parallel] {path} differs from guided_sample_loop "
                 f"(max |diff| {err:.3e})")
    for path, _ in paths:
        print(f"[parallel] {path}: {N_POINTS} / {M_POINTS} points, {STEPS} "
              f"steps, guidance {GUIDANCE}, grid, through the capture runner "
              f"(captures a call {caps[path]}); identical output, and "
              f"identical in its four runs; launches {launches[path]}; "
              f"seconds per cloud "
              f"{', '.join(f'{t:.4f}' for t in secs[path])} ({card})")
    s = secs["guided_sample_loop_sharded"]
    print(f"[parallel] point-sharded sampler on {{'points': 1}}: eager first "
          f"call {s[0]:.4f} s, captured second {s[1]:.4f} s, replays "
          f"{s[2]:.4f} / {s[3]:.4f} s a cloud (the single-device replays "
          f"{', '.join(f'{t:.4f}' for t in secs['guided_sample_loop'][1:])}"
          f"); identical to its eager body and to guided_sample_loop ({card})")
    one_rank = Ranks(0, 1, dev, card, "[parallel]")
    launches["selections replay"] = ranks_selections(
        one_rank, schedule, src, cond, run, points)
    if one_rank.problems:
        fail(f"[parallel] {one_rank.problems}")
    del model, net
    torch.cuda.empty_cache()
    phase_parallel_trainer(dev, card, rng, counted, launches)
    phase_parallel_graph(dev, card, axis_group(points, "points"))
    capture.release()  # the graphs hold the communicators
    dist.destroy_process_group()
    return launches


def phase_parallel_trainer(dev: torch.device, card: str, rng, counted,
                           launches: dict) -> None:
    """``DiffusionTrainer(mesh_shape={"data": 1})`` with its steps through
    the capture runner, at ``Config()`` width in float32 (the bars'
    dtype), against the single-device trainer (captured too) and the
    meshed trainer run eagerly, on the same batches and seeds: 3
    mini-steps and 3 eval steps each (eager, captured, replayed); loss
    terms within 1e-5 of the single-device ones and identical to the eager
    meshed ones, the accumulated gradients at ``GRAD_RTOL`` of both, the
    same launches; a replayed mini-step and eval step profiled, their
    kernels the single-device replay's. Then in bf16, as ``cli.train``
    runs, ms per mini-step of the meshed and the single-device trainer in
    turns."""
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in (
            "checkpoint_dir", "log_dir", "result_dir")}
        tcfg = Config(**dirs, experiment_name="parallel", use_amp=False)
        names = ("train_step", "sharded_train_step",
                 "sharded_train_step eager")
        trainers = dict(zip(names, (
            DiffusionTrainer(tcfg.replace(mesh_shape=mesh), resume=False,
                             device=dev)
            for mesh in ({}, {"data": 1}, {"data": 1}))))
        eager_steps(trainers["sharded_train_step eager"])
        batches = [tuple(np.stack([normalize_point_cloud(make_cloud(
            rng, N_POINTS))[0] for _ in range(tcfg.batch_size)])
            for _ in range(2)) for _ in range(3)]
        worst = {"single": {}, "eager": {}}
        loss_err, caps, terms_all = 0.0, [], []
        for i, (sim, real) in enumerate(batches):
            terms = {}
            for path, t in trainers.items():
                n_cap = len(capture.CAPTURES)
                (ld, _), _ = counted(path, lambda: t.train_step(
                    t._batch(sim), t._batch(real), 1e-4))
                terms[path] = {k: float(v) for k, v in ld.items()}
                if path == "sharded_train_step":
                    caps.append(len(capture.CAPTURES) - n_cap)
            if not (launches["sharded_train_step"] == launches["train_step"]
                    == launches["sharded_train_step eager"]
                    == {k: v for k, v in TRAIN_STEP_LAUNCHES.items() if v}):
                fail(f"[parallel] mini-step launches "
                     f"{ {p: launches[p] for p in names} }")
            mine = terms["sharded_train_step"]
            if mine != terms["sharded_train_step eager"]:
                fail(f"[parallel] captured meshed mini-step {i + 1}'s loss "
                     f"terms {mine} != eager meshed "
                     f"{terms['sharded_train_step eager']}")
            loss_err = max(loss_err, max(
                abs(mine[k] / terms["train_step"][k] - 1) for k in mine))
            terms_all.append(mine)
            if i < 2:  # accumulated, not yet applied
                for other, name in (("single", "train_step"),
                                    ("eager", "sharded_train_step eager")):
                    for part, v in acc_grads_err(
                            trainers["sharded_train_step"],
                            trainers[name]).items():
                        worst[other][part] = max(worst[other].get(part, 0.0),
                                                 v)
        if caps != [0, 1, 0]:
            fail(f"[parallel] the meshed trainer's captures a mini-step "
                 f"{caps} (0, 1, 0 expected)")
        evals, eval_caps = [], []
        for sim, real in batches:
            row = {}
            for path, t in trainers.items():
                n_cap = len(capture.CAPTURES)
                ld, _ = counted(f"{path} eval", lambda: t.eval_step(
                    t._batch(sim), t._batch(real)))
                row[path] = float(ld["total_loss"])
                if path == "sharded_train_step":
                    eval_caps.append(len(capture.CAPTURES) - n_cap)
                if launches[f"{path} eval"] != {
                        k: v for k, v in EVAL_STEP_LAUNCHES.items() if v}:
                    fail(f"[parallel] {path} eval launches "
                         f"{launches[f'{path} eval']}")
            evals.append(row)
        eval_err = max(abs(r["sharded_train_step"] / r[p] - 1)
                       for r in evals for p in ("train_step",
                                                "sharded_train_step eager"))
        if eval_caps != [0, 1, 0]:
            fail(f"[parallel] the meshed trainer's captures an eval step "
                 f"{eval_caps} (0, 1, 0 expected)")
        same = torch.equal(flat(trainers["train_step"].params),
                           flat(trainers["sharded_train_step"].params))
        gaps = {k: ", ".join(f"{p} {v:.3g}" for p, v in w.items())
                for k, w in worst.items()}
        if loss_err > 1e-5 or eval_err > 1e-5 or max(
                max(w.values()) for w in worst.values()) > 1.0:
            fail(f"[parallel] captured meshed trainer: loss {loss_err:.3e}, "
                 f"eval {eval_err:.3e} relative (bar 1e-5), gradients over "
                 f"their bars by part: {gaps}")
        sim, real = batches[0]
        profiles = {}
        for path in ("train_step", "sharded_train_step"):
            t = trainers[path]
            for kind, fn, want in (
                    ("mini-step", lambda: t.train_step(
                        t._batch(sim), t._batch(real), 1e-4),
                     TRAIN_STEP_LAUNCHES),
                    ("eval step", lambda: t.eval_step(
                        t._batch(sim), t._batch(real)), EVAL_STEP_LAUNCHES)):
                reset_launch_counts()
                _, got, n_all, busy, wall = profiled_replay(fn, want)
                if got != want:
                    fail(f"[parallel] a profiled replayed {path} {kind} ran "
                         f"{got}")
                profiles[(path, kind)] = (n_all, busy, wall)
        print(f"[parallel] DiffusionTrainer(mesh_shape={{'data': 1}}), its "
              f"steps captured (calls: eager, captured, replayed), vs the "
              f"single-device trainer (captured) and the meshed trainer run "
              f"eagerly, Config() width, float32, B={tcfg.batch_size}, 3 "
              f"mini-steps and 3 eval steps: loss terms identical to the "
              f"eager meshed ones {terms_all}, {loss_err:.3e} relative to the "
              f"single-device ones (bar 1e-5), eval {eval_err:.3e}; "
              f"accumulated gradients over their bars by part (1 is the "
              f"bar), vs single-device: {gaps['single']}; vs eager meshed: "
              f"{gaps['eager']}; parameters after the optimizer step "
              f"identical to the single-device trainer's: {same}; launches "
              f"a mini-step {launches['sharded_train_step']}, an eval step "
              f"{launches['sharded_train_step eval']} ({card})")
        for (path, kind), (n_all, busy, wall) in profiles.items():
            print(f"[parallel] profiled replayed {path} {kind}: the port's "
                  f"kernels as the single-device replay's; wall {wall:.2f} "
                  f"ms, device busy {busy:.2f} ms, {n_all} device kernels "
                  f"and copies ({card})")
        del trainers
        torch.cuda.empty_cache()

        bf16 = Config(**dirs, experiment_name="parallel_bf16")
        pair = {"single-device": DiffusionTrainer(bf16, resume=False,
                                                  device=dev),
                "{'data': 1}": DiffusionTrainer(bf16.replace(
                    mesh_shape={"data": 1}), resume=False, device=dev)}
        ms = {k: [] for k in pair}
        data = [tuple(t for t in (pair["single-device"]._batch(s),
                                  pair["single-device"]._batch(r)))
                for s, r in batches]
        for i in range(8):
            sim, real = data[i % 3]
            for name, t in pair.items():
                _, s = timed(lambda: t.train_step(sim, real, 1e-4))
                ms[name].append(1e3 * s)
        print(f"[parallel] Config() (bf16, B={bf16.batch_size}) ms per "
              f"mini-step in turns (first call eager, second captured, then "
              f"replays): "
              + "; ".join(f"{k} {', '.join(f'{v:.2f}' for v in ts)} "
                          f"(replays mean {np.mean(ts[2:]):.2f}, best "
                          f"{min(ts[2:]):.2f})" for k, ts in ms.items())
              + f" ({card})")
        del pair
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sampler_draws(gen: torch.Generator, dev: torch.device) -> dict:
    """One 120,000-point cloud's sampler draws at ``STEPS`` steps, from
    ``gen`` in the sampler's own order."""
    return dict(
        x_init=torch.randn((1, N_POINTS, 3), generator=gen, device=dev),
        cond_priority=torch.rand((1, N_POINTS), generator=gen, device=dev),
        step_priorities=torch.rand((STEPS, 1, N_POINTS), generator=gen,
                                   device=dev),
        fps_starts=torch.randint(0, 512, (2, 1), generator=gen, device=dev))


def normalized_clouds(rng: np.random.Generator, n: int) -> torch.Tensor:
    """[n, N_POINTS, 3] normalised scenes without duplicate points, on the
    CPU."""
    return torch.from_numpy(np.stack([normalize_point_cloud(make_cloud(
        rng, N_POINTS, dup_frac=0.0))[0] for _ in range(n)]))


def broadcast_tensors(tensors, dev: torch.device, src: int = 0) -> dict:
    """``tensors`` (a dict of tensors on rank ``src``, None on the others)
    on every rank, on ``dev``: the names, shapes and dtypes as one object,
    then each tensor by a collective of its own. (A CUDA tensor pickled
    through ``broadcast_object_list`` would unpickle onto the sender's
    card.)"""
    import torch.distributed as dist
    meta = [None if tensors is None else
            [(k, tuple(v.shape), v.dtype) for k, v in tensors.items()]]
    dist.broadcast_object_list(meta, src=src)
    out = {}
    for name, shape, dtype in meta[0]:
        t = (torch.empty(shape, dtype=dtype, device=dev) if tensors is None
             else tensors[name].to(dev).contiguous())
        dist.broadcast(t, src=src)
        out[name] = t
    return out


class Ranks:
    """One rank of a group on the cards: its place, its card, how its lines
    start, and the departures it noted (a rank that noted one exits
    non-zero at the end, after every check has run)."""

    def __init__(self, rank: int, world: int, dev: torch.device, card: str,
                 tag: str = "[parallel ranks]"):
        self.rank, self.world, self.dev, self.card = rank, world, dev, card
        self.tag, self.problems = tag, []

    def check(self, ok: bool, what: str) -> bool:
        if not ok:
            self.problems.append(what)
            print(f"{self.tag} DEPARTURE (rank {self.rank}): {what}",
                  file=sys.stderr, flush=True)
        return ok

    def same(self, what: str, x: torch.Tensor) -> bool:
        """Whether ``x`` is the same, bit for bit, on every rank."""
        import torch.distributed as dist
        x = x.reshape(-1)
        every = x.new_empty(self.world * x.numel())
        dist.all_gather_into_tensor(every, x.contiguous())
        return self.check(all(torch.equal(e, x) for e in every.chunk(
            self.world)), f"{what} differs between the ranks")

    def counts(self) -> dict:
        return {k: v for k, v in LAUNCH_COUNTS.items() if v}


# Chamfer-L2 of a float32 replay of the one-card run's choices from its
# cloud: the [reference] bar
SELECTIONS_BAR = 1e-3


def ranks_selections(r: Ranks, schedule, src: torch.Tensor,
                     cond: torch.Tensor, run: dict, points) -> dict:
    """The point-sharded sampler held to one card through the one card's
    choices, with a float32 and a bf16 model (``Config()`` otherwise):
    rank 0 runs ``guided_sample_loop`` with ``selections={}`` (each step's
    voxel order and upsample neighbours recorded), then replays the record
    on its one card, and broadcasts the record and both clouds; every rank
    replays the record through ``guided_sample_loop(mesh=points,
    selections=)`` with the same draws. In float32 the replay lies within
    ``SELECTIONS_BAR`` Chamfer-L2 of the recorded cloud; in bf16 the
    readings are printed and not held: a replay interpolates with the
    recorded neighbours in plain arithmetic where the recording run's
    kernel computed its own weights, and bf16's rounding of the denoiser's
    output carries those last-bit differences from step to step. Every
    cloud and reading is the same on every rank. Returns the float32
    replay's launches."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.ops import chamfer_distance_l2
    from pointcloud_style_transfer_torch.parallel.mesh import axis_size
    n = axis_size(points, "points")
    launches = {}
    for dtype, use_amp in (("float32", False), ("bf16", True)):
        torch.manual_seed(PARALLEL_SEED)
        model = PointCloudDiffusionModel(Config(use_amp=use_amp), r.dev)
        recorded, one_s, rec_counts = None, 0.0, {}
        clouds = {k: torch.empty_like(src) for k in ("recorded", "replayed")}
        if r.rank == 0:
            recorded = {}
            reset_launch_counts()
            clouds["recorded"], one_s = timed(lambda: guided_sample_loop(
                model, schedule, src, cond, selections=recorded, **run))
            rec_counts = r.counts()
            clouds["replayed"] = guided_sample_loop(
                model, schedule, src, cond, selections=dict(recorded), **run)
        recorded = broadcast_tensors(recorded, r.dev)
        for cloud in clouds.values():
            dist.broadcast(cloud, src=0)
        reset_launch_counts()
        got, s = timed(lambda: guided_sample_loop(
            model, schedule, src, cond, mesh=points,
            selections=dict(recorded), **run))
        counts = r.counts()
        launches = launches or counts
        cd = {k: float(chamfer_distance_l2(got, c)[0])
              for k, c in clouds.items()}
        r.same(f"the {dtype} replayed cloud", got)
        r.same(f"the {dtype} replay's Chamfer-L2 readings", torch.tensor(
            list(cd.values()), dtype=torch.float64, device=r.dev))
        want = {k: v for k, v in expect_counts(fps=2, ball_query=2).items()
                if v}
        r.check(counts == want, f"the {dtype} selections replay launched "
                f"{counts} != {want}")
        if dtype == "float32":
            r.check(cd["recorded"] <= SELECTIONS_BAR, f"the float32 "
                    f"selections replay lies at Chamfer-L2 "
                    f"{cd['recorded']:.3g} from the recorded cloud (bar "
                    f"{SELECTIONS_BAR})")
        mib = sum(t.numel() * t.element_size()
                  for t in recorded.values()) / 2**20
        held = (f"bar {SELECTIONS_BAR}" if dtype == "float32" else
                "not held: bf16 rounding carries the replay's last-bit "
                "interpolation differences")
        print(f"{r.tag} selections replay, {dtype}, on {{'points': {n}}}, "
              f"{N_POINTS} / {M_POINTS} points, {STEPS} steps, grid: the "
              f"one-card run recording its choices {one_s:.4f} s (eager, "
              f"launches {rec_counts}), {len(recorded)} records "
              f"({mib:.1f} MiB) broadcast; each rank's replay {s:.4f} s "
              f"(eager, launches {counts}); Chamfer-L2 from the recorded "
              f"cloud {cd['recorded']:.6g} ({held}; max |d| "
              f"{float((got - clouds['recorded']).abs().max()):.3g}), from "
              f"the one-card replay {cd['replayed']:.6g} (max |d| "
              f"{float((got - clouds['replayed']).abs().max()):.3g}); "
              f"clouds and readings the same on every rank ({r.card})")
        del model, recorded
    return launches


RING_RTOL = 1e-6  # the ring Chamfers against the one-card Chamfers


def ranks_ring(r: Ranks, mesh, name: str) -> None:
    """``ring_knn`` (k = 3), ``ring_min_sq_dist`` and both ring Chamfers
    on ``mesh``'s points axis at 120,000 x 120,000, each rank holding its
    shards, against the one-card calls on card 0 on the whole clouds
    (``knn(..., backend="pallas")``, ``min_sq_dist``, ``chamfer_distance``
    and ``_l2``), broadcast: the kNN and the minima identical on each
    rank's rows, the Chamfers within ``RING_RTOL`` relative and the same on
    every rank; launches a rank: one ``knn_topk`` or ``rowmin`` a hop (two
    for a Chamfer)."""
    from pointcloud_style_transfer_torch.ops import chamfer_distance_l2
    from pointcloud_style_transfer_torch.parallel.mesh import (
        POINTS_AXIS, axis_size, local_slice)
    from pointcloud_style_transfer_torch.parallel.ring import (
        ring_chamfer_distance, ring_chamfer_distance_l2, ring_knn,
        ring_min_sq_dist)

    n = axis_size(mesh, POINTS_AXIS)
    q, ref = normalized_clouds(np.random.default_rng(PARALLEL_SEED + 4),
                               2).to(r.dev).split(1)

    def loc(t):
        return local_slice(t, 1, mesh, POINTS_AXIS)
    calls = {"ring_knn": (lambda: ring_knn(loc(q), loc(ref), 3, mesh),
                          {"knn_topk": n}),
             "ring_min_sq_dist": (lambda: ring_min_sq_dist(loc(q), loc(ref),
                                                           mesh),
                                  {"rowmin": n}),
             "ring_chamfer_distance": (lambda: ring_chamfer_distance(
                 loc(q), loc(ref), mesh), {"rowmin": 2 * n}),
             "ring_chamfer_distance_l2": (lambda: ring_chamfer_distance_l2(
                 loc(q), loc(ref), mesh), {"rowmin": 2 * n})}
    got, launches, ms = {}, {}, {}
    for call, (fn, want) in calls.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        got[call] = fn()
        torch.cuda.synchronize()
        launches[call] = r.counts()
        r.check(launches[call] == want, f"{call} on {name} launched "
                f"{launches[call]} != {want}")
        ms[call] = cuda_ms(fn, 5)
    dense, dense_ms = None, {}
    if r.rank == 0:  # the one-card calls on card 0
        with torch.no_grad():
            d, i = knn(q, ref, 3, backend="pallas")
            d4 = knn(q, ref, 4, backend="pallas")[0]
            dense = {"knn_d": d, "knn_i": i, "min": min_sq_dist(q, ref),
                     "chamfer": chamfer_distance(q, ref),
                     "chamfer_l2": chamfer_distance_l2(q, ref),
                     "ties": (d4.diff(dim=-1) == 0).any(-1).sum()[None]}
            dense_ms = {
                "ring_knn": cuda_ms(lambda: knn(q, ref, 3, backend="pallas"),
                                    5),
                "ring_min_sq_dist": cuda_ms(lambda: min_sq_dist(q, ref), 5),
                "ring_chamfer_distance": cuda_ms(
                    lambda: chamfer_distance(q, ref), 5),
                "ring_chamfer_distance_l2": cuda_ms(
                    lambda: chamfer_distance_l2(q, ref), 5)}
    dense = broadcast_tensors(dense, r.dev)
    (kd, ki), low = got["ring_knn"], got["ring_min_sq_dist"]
    for what, mine, want in (("ring_knn's distances", kd, dense["knn_d"]),
                             ("ring_knn's indices", ki, dense["knn_i"]),
                             ("ring_min_sq_dist", low, dense["min"])):
        want = loc(want)
        r.check(torch.equal(mine, want), f"{what} on {name} differ from the "
                f"one-card call on {int((mine != want).sum())} of "
                f"{want.numel()} entries")
    gaps = {}
    for call, key in (("ring_chamfer_distance", "chamfer"),
                      ("ring_chamfer_distance_l2", "chamfer_l2")):
        r.same(f"{call} on {name}", got[call])
        gaps[call] = float((got[call] / dense[key] - 1).abs().max())
        r.check(gaps[call] <= RING_RTOL, f"{call} on {name}: "
                f"{gaps[call]:.3g} relative from the one-card call (bar "
                f"{RING_RTOL})")
    print(f"{r.tag} ring on {name} ({n} ranks a ring), {N_POINTS} x "
          f"{N_POINTS}, each rank holding {N_POINTS // n} rows of each "
          f"cloud: ring_knn (k=3) distances and indices and "
          f"ring_min_sq_dist identical to the one-card calls on every "
          f"rank's rows ({int(dense['ties'][0])} of {N_POINTS} query rows "
          f"with a tie among their 4 nearest); ring Chamfer relative gaps "
          + ", ".join(f"{c} {v:.3g}" for c, v in gaps.items())
          + f" (bar {RING_RTOL}), the same on every rank; launches a rank "
          f"{launches}; ms a call (rank 0) "
          + ", ".join(f"{c} {v:.3f}" for c, v in ms.items())
          + "; one card on the whole clouds "
          + ", ".join(f"{c} {v:.3f}" for c, v in dense_ms.items())
          + f" ({r.card})")


def ranks_dp(r: Ranks, model, schedule, data) -> None:
    """``guided_sample_loop_dp`` on ``data``'s axis, one 120,000-point cloud
    a rank with explicit ``draws[g]``: the gathered [n, N, 3] result the
    same on every rank, and cloud g identical (``torch.equal``) to
    ``guided_sample_loop`` of cloud g with ``draws[g]`` on card 0."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.parallel import guided_sample_loop_dp
    from pointcloud_style_transfer_torch.parallel.mesh import (DATA_AXIS,
                                                               axis_size)

    n = axis_size(data, DATA_AXIS)
    rng = np.random.default_rng(PARALLEL_SEED + 5)
    srcs, conds = (normalized_clouds(rng, n).to(r.dev) for _ in range(2))
    gen = torch.Generator(device=r.dev).manual_seed(PARALLEL_SEED + 5)
    draws = [sampler_draws(gen, r.dev) for _ in range(n)]
    reset_launch_counts()
    out, s = timed(lambda: guided_sample_loop_dp(
        model, schedule, srcs, conds, data, STEPS, GUIDANCE, draws=draws))
    launches = r.counts()
    single = {k: v for k, v in GRAPH_LAUNCHES.items() if v}
    r.check(launches == single, f"guided_sample_loop_dp launched {launches} "
            f"!= {single}")
    r.check(out.shape == (n, N_POINTS, 3) and bool(out.isfinite().all()),
            f"guided_sample_loop_dp returned {tuple(out.shape)}, finite "
            f"{bool(out.isfinite().all())}")
    r.same("the data-parallel clouds", out)
    gaps, single_s = [], []
    if r.rank == 0:
        for g in range(n):
            one, t = timed(lambda: guided_sample_loop(
                model, schedule, srcs[g:g + 1], conds[g:g + 1],
                num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                **draws[g]))
            single_s.append(t)
            gaps.append(float((out[g:g + 1] - one).abs().max()))
            r.check(torch.equal(out[g:g + 1], one), f"data-parallel cloud "
                    f"{g} differs from one card's guided_sample_loop of it "
                    f"(max |d| {gaps[-1]:.3g})")
        print(f"{r.tag} guided_sample_loop_dp on {{'data': {n}}}, {n} clouds "
              f"of {N_POINTS} / {M_POINTS} points (one a rank), {STEPS} "
              f"steps, grid, draws[g] given: {s:.4f} s for the batch (each "
              f"rank's first call of the key eager but rank 0's, launches "
              f"{launches} a rank), the gathered [{n}, {N_POINTS}, 3] the "
              f"same on every rank; cloud by cloud against "
              f"guided_sample_loop on card 0 ("
              + ", ".join(f"{t:.4f}" for t in single_s)
              + f" s): max |d| {gaps} ({r.card})")
    dist.barrier()


STEP_MESH = {"data": 2, "points": 2}  # the JAX dry run's shape family
STEP_SEED, STEP_LR = 60, 1e-3
# tests/test_torch_sharded_step.py's bars: the loss and eval terms
# relative, the gradients JAX's (atol, rtol), BatchNorm's running stats and
# the EMA (atol = rtol)
STEP_LOSS_RTOL, STEP_GRAD_ATOL, STEP_GRAD_RTOL, STEP_STATE_TOL = (
    1e-5, 1e-4, 1e-3, 1e-5)


def share_of_bar(got: torch.Tensor, want: torch.Tensor, atol: float,
                 rtol: float) -> float:
    """The largest |got - want| over atol + rtol |want|: 1.0 is the bar."""
    return float(((got.double() - want.double()).abs()
                  / (atol + rtol * want.double().abs())).max())


def ranks_point_sharded_step(r: Ranks, mesh) -> None:
    """``make_sharded_train_step`` / ``make_sharded_eval_step(...,
    shard_points=True)`` on ``STEP_MESH`` at ``Config()`` width in float32,
    a global batch of 2, against the single-device steps on card 0 on the
    global batch with the same draws, the single-device step's discrete
    selections (``draws["selections"]``: ReLU gates, max-pool argmaxes,
    Chamfer argmins) broadcast and replayed, sliced per rank, as
    ``tests/test_torch_sharded_step.py`` holds them: loss and eval terms
    within ``STEP_LOSS_RTOL``, gradients within JAX's bars, BatchNorm's
    running stats and the EMA within ``STEP_STATE_TOL``, the parameters
    identical on every rank."""
    from pointcloud_style_transfer_torch.parallel import (
        make_sharded_eval_step, make_sharded_train_step, shard_batch)
    from pointcloud_style_transfer_torch.training import (ema_init,
                                                          eval_step,
                                                          make_optimizer,
                                                          train_step)
    from pointcloud_style_transfer_torch.training.trainer import step_draws

    cfg = Config(use_amp=False, gradient_accumulation_steps=1)
    B = 2
    rng = np.random.default_rng(STEP_SEED)
    sim, real = (torch.from_numpy(np.stack([normalize_point_cloud(
        make_cloud(rng, N_POINTS))[0] for _ in range(B)])).to(r.dev)
        for _ in range(2))
    schedule = make_schedule(cfg).to(r.dev)

    def fresh():
        torch.manual_seed(STEP_SEED)
        model = PointCloudDiffusionModel(cfg, r.dev)
        params = dict(model.net.named_parameters())
        opt, ema = make_optimizer(cfg, params), ema_init(params)
        grads, step = [], opt.step

        def recorded(p, g, lr):
            grads.append(torch.cat([x.reshape(-1) for x in g]))
            return step(p, g, lr)
        opt.step = recorded
        return model, opt, ema, grads

    def draws(model, train: bool, seed: int) -> dict:
        return step_draws(model, B, N_POINTS, N_POINTS, train=train,
                          generator=torch.Generator(device=r.dev)
                          .manual_seed(seed))

    def state(model, terms, grads, ema, e_terms) -> dict:
        return {"loss": torch.stack([terms[k] for k in sorted(terms)]),
                "grads": grads[-1],
                "stats": flat(dict(model.net.named_buffers())),
                "ema": flat(ema), "params": flat(dict(
                    model.net.named_parameters())),
                "eval": torch.stack([e_terms[k] for k in sorted(e_terms)])}

    single, selections, single_s = None, None, 0.0
    if r.rank == 0:
        model, opt, ema, grads = fresh()
        selections = {}
        t0 = time.perf_counter()
        terms, _ = train_step(model, schedule, opt, ema, sim, real, STEP_LR,
                              draws={**draws(model, True, 7),
                                     "selections": selections})
        e_terms = eval_step(model, schedule, ema, sim, real,
                            draws=draws(model, False, 8))
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        single = state(model, terms, grads, ema, e_terms)
        del model, opt, ema, grads
    selections = broadcast_tensors(selections, r.dev)
    single = broadcast_tensors(single, r.dev)
    model, opt, ema, grads = fresh()
    step = make_sharded_train_step(model, schedule, opt, cfg, mesh,
                                   shard_points=True)
    evaluate = make_sharded_eval_step(model, schedule, cfg, mesh,
                                      shard_points=True)
    sim_l, real_l = (shard_batch(x, mesh, shard_points=True)
                     for x in (sim, real))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    terms, _ = step(ema, sim_l, real_l, STEP_LR,
                    draws={**draws(model, True, 7), "selections": selections})
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = r.counts()
    e_terms = evaluate(ema, sim_l, real_l, draws=draws(model, False, 8))
    mine = state(model, terms, grads, ema, e_terms)
    names = sorted(terms)
    loss_gap = float((mine["loss"] / single["loss"] - 1).abs().max())
    eval_gap = float((mine["eval"] / single["eval"] - 1).abs().max())
    grad_share = {}
    for part, g, w in zip(opt.names, mine["grads"].split(opt.sizes),
                          single["grads"].split(opt.sizes)):
        part = part.split(".")[0]
        grad_share[part] = max(grad_share.get(part, 0.0), share_of_bar(
            g, w, STEP_GRAD_ATOL, STEP_GRAD_RTOL))
    state_share = {k: share_of_bar(mine[k], single[k], STEP_STATE_TOL,
                                   STEP_STATE_TOL) for k in ("stats", "ema")}
    r.check(loss_gap <= STEP_LOSS_RTOL, f"point-sharded loss terms "
            f"{loss_gap:.3g} relative from the single-device step (bar "
            f"{STEP_LOSS_RTOL})")
    r.check(eval_gap <= STEP_LOSS_RTOL, f"point-sharded eval terms "
            f"{eval_gap:.3g} relative (bar {STEP_LOSS_RTOL})")
    r.check(max(grad_share.values()) <= 1.0, f"point-sharded gradients "
            f"over JAX's bars: {grad_share} of them")
    r.check(max(state_share.values()) <= 1.0, f"point-sharded BatchNorm "
            f"stats / EMA over their bars: {state_share} of them")
    r.same("the point-sharded step's parameters", mine["params"])
    r.same("the point-sharded step's loss terms", mine["loss"])
    print(f"{r.tag} point-sharded train and eval steps on {STEP_MESH} "
          f"(make_sharded_train_step / make_sharded_eval_step, "
          f"shard_points=True), Config() width, float32, a global batch of "
          f"{B} (each rank [1, {N_POINTS // 2}, 3]), against the "
          f"single-device steps on card 0 ({single_s:.3f} s eager, "
          f"recording {len(selections)} selections; broadcast, replayed "
          f"sliced per rank; a rank's train step {step_s:.3f} s): loss terms "
          f"{dict(zip(names, mine['loss'].tolist()))}, {loss_gap:.3g} "
          f"relative (bar {STEP_LOSS_RTOL}); gradients as shares of JAX's "
          f"bars (atol {STEP_GRAD_ATOL}, rtol {STEP_GRAD_RTOL}; 1 is the "
          f"bar) by module {grad_share}; BatchNorm running stats and EMA "
          f"{state_share} of the {STEP_STATE_TOL} bars; "
          f"eval terms {eval_gap:.3g} relative; parameters identical on "
          f"every rank; launches a rank {launches} ({r.card})")


def parallel_ranks(rank: int, world: int, port: int) -> None:
    """One of ``--ranks world`` processes, one a card, on an NCCL group of
    ``world`` ranks (``tcp://localhost:port``), each path checked against
    its single-card counterpart on card 0 with the same inputs and draws:
    ``[parallel graph]`` (an NCCL kernel in every replay); the
    point-sharded sampler at {points: world} with its collectives inside
    its graph, held to its eager body, and replaying the one-card run's
    choices (``ranks_selections``); ``guided_sample_loop_dp`` on {data:
    world}; the ring on {points: world} and, from 4 ranks, on
    ``STEP_MESH``; the point-sharded train and eval steps on
    ``STEP_MESH`` (refused, with a line naming it, below 4 ranks);
    ``DiffusionTrainer(mesh_shape={"data": world})`` captured vs eager.
    Only rank 0 prints its lines; a departure is noted on stderr and the
    run goes on; a rank that noted one exits non-zero at the end."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.ops import chamfer_distance_l2
    from pointcloud_style_transfer_torch.parallel import (
        guided_sample_loop_sharded, make_mesh)
    from pointcloud_style_transfer_torch.parallel.mesh import axis_group

    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    r = Ranks(rank, world, dev, card_line())
    card, check = r.card, r.check
    n_step = int(np.prod(list(STEP_MESH.values())))
    # every mesh, made by every rank in the same order
    points = make_mesh({"points": world}, "cuda")
    data = make_mesh({"data": world}, "cuda")
    two_d = make_mesh(STEP_MESH, "cuda") if world == n_step else None
    print(f"[parallel ranks] {world} ranks, one a card, NCCL; "
          f"{library_versions()} ({card})")
    if two_d is None:
        print(f"[parallel ranks] REFUSED {STEP_MESH}: the ring on it and the "
              f"point-sharded train and eval steps run on {n_step} ranks, "
              f"--ranks {world} has {world}; not run, and no other shape in "
              f"its place")
    phase_parallel_graph(dev, card, axis_group(points, "points"))

    cfg = Config()
    torch.manual_seed(PARALLEL_SEED)
    model = PointCloudDiffusionModel(cfg, dev)
    schedule = make_schedule(cfg).to(dev)
    rng = np.random.default_rng(PARALLEL_SEED)
    src, cond = (torch.from_numpy(normalize_point_cloud(
        make_cloud(rng, N_POINTS, dup_frac=0.0))[0])[None].to(dev)
        for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
    run = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE,
               **sampler_draws(gen, dev))

    def sharded():
        return guided_sample_loop_sharded(model, schedule, src, cond, points,
                                          **run)
    with eager_samplers():
        eager, eager_s = timed(sharded)
    single = {k: v for k, v in GRAPH_LAUNCHES.items() if v}
    secs, caps = [], []
    for call in range(4):  # eager, captured + replayed, replays
        n_cap = len(capture.CAPTURES)
        reset_launch_counts()
        out, s = timed(sharded)
        secs.append(s)
        caps.append(len(capture.CAPTURES) - n_cap)
        got = r.counts()
        check(got == single, f"sharded sampler call {call + 1} launched "
              f"{got} != {single}")
        check(torch.equal(out, eager), f"sharded sampler call {call + 1} "
              f"differs from its eager body (max |d| "
              f"{(out - eager).abs().max().item():.3g})")
    check(caps == [0, 1, 0, 0], f"sharded sampler captures a call {caps}")
    r.same("the sharded sampler's cloud", out)
    dist.barrier()
    if rank == 0:  # the single-device sampler on one card, the others wait
        single_s = []
        for _ in range(4):
            ref, s = timed(lambda: guided_sample_loop(model, schedule, src,
                                                      cond, **run))
            single_s.append(s)
        print(f"[parallel ranks] point-sharded sampler on {{'points': "
              f"{world}}}, {N_POINTS} / {M_POINTS} points, {STEPS} steps, "
              f"grid: eager body {eager_s:.4f} s; through the capture runner "
              f"eager {secs[0]:.4f} s, captured {secs[1]:.4f} s, replays "
              f"{secs[2]:.4f} / {secs[3]:.4f} s a cloud (captures a call "
              f"{caps}), launches {single} a rank; the single-device sampler "
              f"on one card {', '.join(f'{t:.4f}' for t in single_s)} s "
              f"(eager, captured, replays); sharded vs single-device, its own "
              f"choices: max |d| {(out - ref).abs().max().item():.3g}, "
              f"Chamfer-L2 {float(chamfer_distance_l2(out, ref)[0]):.3g} "
              f"(no bar: a chaotic loop; held through the choices below) "
              f"({card})")
    dist.barrier()
    ranks_selections(r, schedule, src, cond, run, points)
    ranks_dp(r, model, schedule, data)
    del model
    torch.cuda.empty_cache()

    ranks_ring(r, points, f"{{'points': {world}}}")
    if two_d is not None:
        ranks_ring(r, two_d, str(STEP_MESH))
        ranks_point_sharded_step(r, two_d)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in (
            "checkpoint_dir", "log_dir", "result_dir")}
        tcfg = Config(**dirs, experiment_name="ranks", use_amp=False,
                      batch_size=world, mesh_shape={"data": world})
        captured, eager_t = (DiffusionTrainer(tcfg, resume=False, device=dev)
                             for _ in range(2))
        eager_steps(eager_t)
        batches = [tuple(np.stack([normalize_point_cloud(make_cloud(
            rng, N_POINTS))[0] for _ in range(world)]) for _ in range(2))
            for _ in range(3)]
        worst, caps, loss_gap, terms_all = {}, [], 0.0, []
        for i, (sim, real) in enumerate(batches):
            terms = []
            for t in (captured, eager_t):
                n_cap = len(capture.CAPTURES)
                ld, _ = t.train_step(t._batch(sim), t._batch(real), 1e-4)
                terms.append({k: float(v) for k, v in ld.items()})
                if t is captured:
                    caps.append(len(capture.CAPTURES) - n_cap)
            loss_gap = max(loss_gap, max(abs(terms[0][k] / terms[1][k] - 1)
                                         for k in terms[0]))
            terms_all.append(terms[0])
            if i < 2:
                for part, v in acc_grads_err(captured, eager_t).items():
                    worst[part] = max(worst.get(part, 0.0), v)
        evals = [[float(t.eval_step(t._batch(sim), t._batch(real))
                        ["total_loss"]) for t in (captured, eager_t)]
                 for sim, real in batches]
        eval_gap = max(abs(a / b - 1) for a, b in evals)
        check(caps == [0, 1, 0], f"meshed trainer captures a mini-step "
              f"{caps}")
        check(loss_gap <= 1e-5 and eval_gap <= 1e-5 and
              max(worst.values()) <= 1.0, f"meshed trainer captured vs "
              f"eager: loss {loss_gap:.3g}, eval {eval_gap:.3g} relative, "
              f"gradient gaps {worst}")
        r.same("the meshed trainer's parameters", flat(captured.params))
        sim, real = batches[0]
        every = [dist.group.WORLD] if world > 1 else []
        reset_launch_counts()
        _, got, n_all, busy, wall = profiled_replay(
            lambda: captured.train_step(captured._batch(sim),
                                        captured._batch(real), 1e-4),
            TRAIN_STEP_LAUNCHES, every)
        check(got == TRAIN_STEP_LAUNCHES, f"a profiled replayed meshed "
              f"mini-step ran {got}")
        train_graph = next(e.graph.graph for k, e in
                           capture._ENTRIES["step"].items()
                           if k[0][0] == "train" and e.graph is not None)
        nccl = [(k, c) for k, c in replay_events(train_graph, every)
                if "nccl" in k.lower()]
        del train_graph
        check(bool(nccl) or world == 1, "no NCCL kernel in a replayed "
              "meshed mini-step")
        print(f"[parallel ranks] DiffusionTrainer(mesh_shape={{'data': "
              f"{world}}}), Config() width, float32, a global batch of "
              f"{world}, captured (eager, captured, replayed; captures "
              f"{caps}) vs eager, 3 mini-steps and 3 eval steps: loss terms "
              f"{'identical' if loss_gap == 0 else f'{loss_gap:.3g} apart'} "
              f"{terms_all}; accumulated gradients over their bars by part "
              f"(1 is the bar): {worst}; eval {eval_gap:.3g} relative; a "
              f"profiled replayed mini-step: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms, {n_all} device kernels and copies; NCCL "
              f"kernels in the train graph's replay {nccl} ({card})")
        del captured, eager_t
        torch.cuda.empty_cache()
        bf16 = Config(**dirs, experiment_name="ranks_bf16", batch_size=world,
                      mesh_shape={"data": world})
        t = DiffusionTrainer(bf16, resume=False, device=dev)
        data_b = [(t._batch(s), t._batch(r_)) for s, r_ in batches]
        ms = [1e3 * timed(lambda: t.train_step(*data_b[i % 3], 1e-4))[1]
              for i in range(8)]
        dist.barrier()
        if rank == 0:
            one = DiffusionTrainer(bf16.replace(batch_size=1, mesh_shape={}),
                                   resume=False, device=dev)
            one_data = [(one._batch(s[:1]), one._batch(r_[:1]))
                        for s, r_ in batches]
            one_ms = [1e3 * timed(lambda: one.train_step(
                *one_data[i % 3], 1e-4))[1] for i in range(8)]
            print(f"[parallel ranks] Config() (bf16) ms per mini-step "
                  f"(first call eager, second captured, then replays): "
                  f"{{'data': {world}}} at a global batch of {world} "
                  f"{', '.join(f'{v:.2f}' for v in ms)} (replays mean "
                  f"{np.mean(ms[2:]):.2f}); one card at B = 1 "
                  f"{', '.join(f'{v:.2f}' for v in one_ms)} (replays mean "
                  f"{np.mean(one_ms[2:]):.2f}) ({card})")
            del one
        del t
        dist.barrier()
    # the graphs hold the communicators: a four-card run that destroyed
    # the group with its graphs alive hung at its end
    t0 = time.perf_counter()
    print(f"[parallel ranks] rank {rank}: checks done {t0 - T_START:.1f} s "
          f"after it started; teardown", file=sys.stderr, flush=True)
    capture.release()
    t1 = time.perf_counter()
    dist.destroy_process_group()
    print(f"[parallel ranks] rank {rank}: graphs released in "
          f"{t1 - t0:.3f} s, the process group destroyed in "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr, flush=True)
    if r.problems:
        fail(f"[parallel ranks] rank {rank}: {len(r.problems)} departures: "
             f"{r.problems}")


# the whole --ranks run after the build: the ranks, their teardown and the
# two cli.test runs; on four NVIDIA H100 80GB HBM3 (700 W) that took
# 71.9 s (86.0 s with the build and the start-up), so 240 s is 3.3 times it
RANKS_DEADLINE_S = 240
RANKS_TEST_RTOL = 1e-5  # cli.test's ring metrics on n ranks against one


def run_bounded(cmd: list, timeout: float, env: dict) -> tuple:
    """``cmd`` in a session of its own: (its exit code, its output, its
    seconds). Past ``timeout`` every process of the session is killed (a
    launcher's workers too) and the run fails."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=max(1.0, timeout))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        fail(f"{' '.join(cmd[:6])} ...: still running after {timeout:.0f} s;"
             f" its output ends:\n{out[-4000:]}")
    return proc.returncode, out, time.perf_counter() - t0


def build_snapshot() -> dict:
    """Every file under the kernels' build directory with its mtime."""
    return {str(p): p.stat().st_mtime_ns
            for p in sorted(_common.BUILD_ROOT.rglob("*")) if p.is_file()}


def ranks_cli_test(world: int, card: str, deadline: float) -> None:
    """``cli.test`` from a fresh-init ``Config()`` checkpoint on two
    synthetic 120,000-point pairs at ``--batch_size 2``, 50 steps, every
    metric: once as one process on card 0, once under ``python -m
    torch.distributed.run --nproc_per_node world`` (rank 0 samples as the
    one process does and broadcasts the clouds; the ring computes the
    Chamfer and content terms). The metrics rank 0 computes alone are
    identical, the ring's within ``RANKS_TEST_RTOL`` relative; neither run
    builds a kernel (the build directory is unchanged)."""
    from pointcloud_style_transfer_torch.cli.test import METRIC_KEYS
    ring_keys = [k for k in METRIC_KEYS
                 if k.startswith(("chamfer", "content"))]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config()
        torch.manual_seed(PARALLEL_SEED + 6)
        net = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
        ckpt = save_checkpoint(os.path.join(tmp, "model.pt"), cfg,
                               *split_state_dict(net))
        split = os.path.join(tmp, "split")
        pre = PointCloudPreprocessor(total_points=N_POINTS,
                                     global_points=M_POINTS, seed=42)
        rng = np.random.default_rng(PARALLEL_SEED + 6)
        for i in range(TEST_PAIRS):
            pre.save_hierarchical_data(*lidar_scene_pair(rng, N_POINTS),
                                       split, f"test_{i:04d}")
        args = ["-m", "pointcloud_style_transfer_torch.cli.test",
                "--checkpoint", ckpt, "--test_data", split, "--batch_size",
                str(TEST_BATCH), "--compute_all_metrics", "--seed", "0"]
        env = {**os.environ, "PCST_TORCH_KERNEL_CACHE": str(_common.BUILD_ROOT)}
        before = build_snapshot()
        results, secs = [], []
        for name, launcher in (
                ("one process", []),
                (f"torch.distributed.run --nproc_per_node {world}",
                 ["-m", "torch.distributed.run", "--standalone",
                  f"--nproc_per_node={world}"])):
            out_dir = os.path.join(tmp, f"out{len(results)}")
            rc, out, s = run_bounded(
                [sys.executable, *launcher, *args, "--output_dir", out_dir],
                deadline - time.monotonic(), env)
            if rc != 0:
                fail(f"[parallel ranks] cli.test as {name}: rc {rc}; its "
                     f"output ends:\n{out[-4000:]}")
            (stamp,) = os.listdir(out_dir)
            with open(os.path.join(out_dir, stamp, "test_results.json")) as f:
                results.append(json.load(f)["average_metrics"])
            secs.append(s)
        rebuilt = build_snapshot() != before
    one, many = results
    if list(one) != list(METRIC_KEYS) or list(many) != list(METRIC_KEYS) \
            or not all(np.isfinite(v) for v in [*one.values(),
                                                *many.values()]):
        fail(f"[parallel ranks] cli.test metrics: one process {one}, "
             f"{world} ranks {many}")
    differ = [k for k in METRIC_KEYS if k not in ring_keys
              and many[k] != one[k]]
    gaps = {k: abs(many[k] / one[k] - 1) for k in ring_keys}
    print(f"[parallel ranks] cli.test at --batch_size {TEST_BATCH}, "
          f"{TEST_PAIRS} pairs of {N_POINTS} points, {STEPS} steps, every "
          f"metric, --seed 0: one process on card 0 {secs[0]:.1f} s, under "
          f"torch.distributed.run --nproc_per_node {world} {secs[1]:.1f} s "
          f"(each with its start-up); rank 0's own metrics "
          f"{'identical' if not differ else f'differ in {differ}'} "
          f"({sum(k not in ring_keys for k in METRIC_KEYS)} of them); the "
          f"ring's relative gaps "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + f" (bar {RANKS_TEST_RTOL}); kernels "
          f"{'REBUILT' if rebuilt else 'loaded from the build, none rebuilt'}"
          f"; metrics {many} ({card})")
    if differ or max(gaps.values()) > RANKS_TEST_RTOL or rebuilt:
        fail(f"[parallel ranks] cli.test on {world} ranks against one "
             f"process: rank 0's metrics differ in {differ} (one {one}, "
             f"{world} ranks {many}), ring gaps {gaps}, rebuilt {rebuilt}")


def main_ranks(world: int) -> int:
    """``--ranks world``: ``parallel_ranks`` on ``world`` cards, then
    ``ranks_cli_test``, all within ``RANKS_DEADLINE_S``."""
    if torch.cuda.device_count() < world:
        fail(f"--ranks {world} needs {world} cards, this machine has "
             f"{torch.cuda.device_count()}")
    card = card_line()
    t0 = time.monotonic()
    deadline = t0 + RANKS_DEADLINE_S
    ctx = torch.multiprocessing.spawn(parallel_ranks, args=(
        world, free_port()), nprocs=world, join=False)
    try:
        while not ctx.join(timeout=5):  # raises if a rank failed
            if time.monotonic() > deadline:
                fail(f"--ranks {world}: still running after "
                     f"{RANKS_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    joined = time.monotonic() - t0
    print(f"[parallel ranks] the {world} ranks ended by themselves (graphs "
          f"released, process group destroyed) and were joined "
          f"{joined:.1f} s after they started")
    ranks_cli_test(world, card, deadline)
    print(f"[parallel ranks] --ranks {world}: {time.monotonic() - t0:.1f} s "
          f"after the build (deadline {RANKS_DEADLINE_S} s), "
          f"{time.perf_counter() - T_START:.1f} s since the script started "
          f"({card})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    phase_build()
    if sys.argv[1:2] == ["--ranks"]:  # e.g. --ranks 4, on four cards
        return main_ranks(int(sys.argv[2]))
    card = card_line()
    if sys.argv[1:2] == ["--only"]:  # e.g. --only graph,train_graph
        phases = {"graph": phase_graph, "train_graph": phase_train_graph,
                  "parallel": phase_parallel, "proof": phase_proof,
                  "tools": phase_tools,
                  "proof_full": lambda dev, card: phase_proof(dev, card,
                                                              full=True)}
        names = sys.argv[2].split(",") if len(sys.argv) == 3 else []
        if not names or not set(names) <= set(phases):
            fail(f"--only takes a comma list of {sorted(phases)}")
        for name in names:
            print(json.dumps(phases[name](dev, card), default=str))
        return 0
    records = phase_kernels(rng, dev)
    phase_reference(rng, dev)
    counts = phase_main_path(rng, dev, card)
    flat = phase_flat_batch(dev, card)
    graph = phase_graph(dev, card)
    with tempfile.TemporaryDirectory() as work:
        paths = phase_train(rng, dev, card, work)
        phase_train_reference(dev)
        train_graph = phase_train_graph(dev, card)
        records["rowmin"]["launches"] = phase_eval(dev, card, work, paths)
        records["rowmin"]["path"] = "cli.compare"
        test_counts = phase_test(np.random.default_rng(20), dev, card, work,
                                 paths)
        phase_visualize(work)
        phase_progress(card, work)
        phase_benchmark(card, work)
        phase_train_augmentation(np.random.default_rng(21), dev, card, paths)
        proof = phase_proof(dev, card)
    tools = phase_tools(dev, card)
    parallel = phase_parallel(dev, card)
    records["grid_topk"].update(launches=counts["grid_topk"],
                                path="cli.inference --fast")
    records["grid_interp"]["flat_batch"] = flat
    counted = graph.pop("knn_topk_count")
    records["knn_f32packed"]["count_on_device"] = {
        k: counted.pop(k) for k in ("f32packed_count_ms",
                                    "f32packed_buffer_ms")}
    records["knn_topk"]["count_on_device"] = counted
    for name, rec in records.items():
        rec.setdefault("launches", counts[name])
        # what one replay of each captured sampler ran (the profiler's)
        rec["replay_launches"] = {path: got["launches"][name]
                                  for path, got in graph.items()}
        rec["cli_test_launches"] = test_counts[name]
        # what one replayed training mini-step ran (the profiler's)
        rec["train_replay_launches"] = train_graph["launches"][name]
        rec["parallel_launches"] = {path: got[name] for path, got in
                                    parallel.items() if name in got}
        # what the training proof's run launched (its own counts)
        rec["proof_launches"] = proof["launches"][name]
        # what the profiling, probe and demo scripts launched
        rec["tools_launches"] = tools["launches"][name]
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
