"""Benchmark CLI (counterpart of
``pointcloud_style_transfer_tpu/cli/benchmark.py``, the same flags plus
``--device`` and the same JSON keys, less the JAX ``note``):

1. noise-predictor forward latency and peak memory over batch {1, 2, 4, 8}
   x points {30k, 60k, 120k};
2. hierarchical (voxel downsample to ``global_points``, then predict) vs
   direct forward at 120k points;
3. a point-count scaling sweep 10k -> 120k at batch 1;
4. full 50-step guided sampling at batch 1 (``sampling``) and at batch 2, 4
   and 8 (``sampling_batched``).

Seeded random weights and inputs. Each case is called once to warm up (the
sampling cases twice: on the card a sampler's first call with a shape runs
eagerly and its second captures the loop as a CUDA graph, which later
calls replay), then ``--reps`` times, each to a ``torch.cuda.synchronize()``; latencies are the
mean of the warm calls, host clock. Memory is
``torch.cuda.max_memory_allocated()`` over the warm calls (after
``reset_peak_memory_stats()``), in MB; null on the CPU. ``--quick`` runs
small sizes (4,096 points, 5 sampling steps). It writes ``--output`` and
prints the sampling result (else the last forward case) as one JSON line.

    python -m pointcloud_style_transfer_torch.cli.benchmark \\
        [--quick] [--reps 5] [--skip_sampling] [--output results.json] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models import (DiffusionNet, PointCloudDiffusionModel, dtype_of,
                      guided_sample_loop, make_schedule)
from ..ops import voxel_downsample
from ..utils.cache import enable_compilation_cache
from ..utils.logger import get_logger

log = get_logger("benchmark")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, reps: int = 5, warmup: int = 1):
    """(min, mean) seconds of ``reps`` calls after ``warmup`` calls, and the
    peak memory in MB over them (None on the CPU)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    mem = (round(torch.cuda.max_memory_allocated(device) / 1e6, 2)
           if device.type == "cuda" else None)
    return float(np.min(ts)), float(np.mean(ts)), mem


def _randn(shape, device: torch.device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def bench_forward(model: PointCloudDiffusionModel, batch_sizes, point_counts,
                  reps: int):
    """Single noise-predictor forward latency + throughput."""
    dev = model.device
    results = []
    style = torch.zeros((max(batch_sizes), model.config.feature_dim),
                        device=dev)
    for n in point_counts:
        for b in batch_sizes:
            x = _randn((b, n, 3), dev, 0)
            t = torch.zeros((b,), dtype=torch.int64, device=dev)
            try:
                _, tmean, mem = _time(
                    lambda: model.predict_noise(x, t, style[:b]), dev, reps)
                results.append({
                    "batch": b, "points": n,
                    "latency_ms": round(tmean * 1000, 3),
                    "throughput_pts_per_s": round(b * n / tmean, 1),
                    "memory_mb": mem,
                })
                log.info("forward b=%d n=%d: %.2fms (%.0f pts/s)", b, n,
                         tmean * 1000, b * n / tmean)
            except RuntimeError as e:  # e.g. out of memory: record, go on
                results.append({"batch": b, "points": n, "error": str(e)})
                log.warning("forward b=%d n=%d failed: %s", b, n, e)
    return results


def bench_hierarchical_vs_direct(model: PointCloudDiffusionModel, n: int,
                                 reps: int):
    """Hierarchical (voxel down -> predict coarse) vs direct full-resolution
    forward at n points."""
    dev = model.device
    style = torch.zeros((1, model.config.feature_dim), device=dev)
    x = _randn((1, n, 3), dev, 0)
    t = torch.zeros((1,), dtype=torch.int64, device=dev)
    M = model.config.global_points
    gen = torch.Generator(device=dev).manual_seed(1)

    def hier():
        xc, _ = voxel_downsample(x, M, generator=gen)
        return model.predict_noise(xc, t, style)

    t_h, _, mem_h = _time(hier, dev, reps)
    t_d, _, mem_d = _time(lambda: model.predict_noise(x, t, style), dev,
                          reps)
    return {"points": n, "hierarchical_ms": round(t_h * 1000, 3),
            "direct_ms": round(t_d * 1000, 3),
            "speedup": round(t_d / t_h, 2),
            "hierarchical_memory_mb": mem_h, "direct_memory_mb": mem_d}


def bench_sampling(model: PointCloudDiffusionModel, schedule, n: int,
                   steps: int, reps: int, batch: int = 1):
    """Full guided-sampling latency and throughput at batch size ``batch``
    (a batch goes through the grid flat-batched, one pass a step for each
    group of up to 8 clouds)."""
    dev = model.device
    src = _randn((batch, n, 3), dev, 1) * 0.9
    cond = _randn((batch, n, 3), dev, 2) * 0.9
    gen = torch.Generator(device=dev).manual_seed(3)

    def run():
        return guided_sample_loop(model, schedule, src, cond,
                                  num_inference_steps=steps,
                                  guidance_scale=7.5, generator=gen)
    # two warm-ups: the eager first call, then the capture (models.capture)
    _, tmean, mem = _time(run, dev, reps, warmup=2)
    return {"points": n, "steps": steps, "batch": batch,
            "seconds_per_batch": round(tmean, 4),
            "seconds_per_cloud": round(tmean / batch, 4),
            "points_per_sec_per_chip": round(batch * n / tmean, 1),
            "memory_mb": mem}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Benchmark suite")
    parser.add_argument("--output", type=str, default="benchmark_results.json")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--quick", action="store_true",
                        help="small sizes only (CI / CPU)")
    parser.add_argument("--skip_sampling", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    enable_compilation_cache()
    device = resolve_device(args.device)

    if args.quick:
        config = Config(total_points=4096, global_points=1024)
        batch_sizes, point_counts = [1, 2], [1024, 4096]
        scaling = [1024, 2048, 4096]
        sample_steps = 5
    else:
        config = Config()
        batch_sizes, point_counts = [1, 2, 4, 8], [30000, 60000, 120000]
        scaling = [10000, 30000, 60000, 90000, 120000]
        sample_steps = 50

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = DiffusionNet(config.feature_dim, config.time_embed_dim,
                           compute_dtype=dtype_of(config),
                           use_kernels=config.use_pallas)
    model = PointCloudDiffusionModel(config, device, net=net)
    schedule = make_schedule(config).to(device)

    results = {"device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "quick": args.quick}

    log.info("=== forward latency / memory sweep ===")
    results["forward"] = bench_forward(model, batch_sizes, point_counts,
                                       args.reps)

    log.info("=== hierarchical vs direct ===")
    results["hierarchical_vs_direct"] = bench_hierarchical_vs_direct(
        model, point_counts[-1], args.reps)

    log.info("=== scaling sweep ===")
    results["scaling"] = bench_forward(model, [1], scaling, args.reps)

    if not args.skip_sampling:
        log.info("=== full guided sampling ===")
        results["sampling"] = bench_sampling(
            model, schedule, config.total_points, sample_steps,
            max(2, args.reps // 2))
        log.info("=== batched guided sampling (throughput axis) ===")
        results["sampling_batched"] = [
            bench_sampling(model, schedule, config.total_points,
                           sample_steps, max(2, args.reps // 2), batch=b)
            for b in ([2] if args.quick else [2, 4, 8])]

    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results.get("sampling", results["forward"][-1])))
    log.info("Results written to %s", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
