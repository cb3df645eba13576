"""Batched-sampling throughput on the PyTorch port: the counterpart of
``examples/profile_batched_sampler.py``. Points/s on one card for the
50-step CFG sampler (``guided_sample_loop``, guidance 7.5, ``Config()``:
120,000 points, bf16, the kd-grid) at B in {1, 2, 4, 8}, replayed.

At B > 1 the grid runs flat-batched (one structure build, one
``grid_interp`` launch and one fallback ladder a step for a group of up to
8 clouds); the JAX script's ``PCST_FORCE_LAXMAP`` A/B is here the
flat-batched grid against the grid cloud by cloud
(``grid_knn._batched_grid_ok`` held false: one pass a cloud a step), both
measured at every B > 1; ``PCST_FORCE_LAXMAP=1`` measures cloud by cloud
only. Each (B, mode) first drops every graph (the sampler's key does not
hold the mode), then its first call runs eagerly, its second captures the
loop, and ``--reps`` (3) replays are timed on the host's clock to a
synchronise; their launches are checked against the mode. On the card one
more replay of the first batch size is profiled: a replayed cloud's device
kernels by name (the top 15) and the device's busy share.

Usage: python examples/profile_batched_sampler_torch.py [steps] [B ...]
           [--reps 3] [--device cuda|cpu]
           [--config FIELD=VALUE ...]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.models import (  # noqa: E402
    capture, guided_sample_loop, make_schedule)
from pointcloud_style_transfer_torch.ops import grid_knn  # noqa: E402


def launches_want(mode: str, B: int, steps: int, blocks: int = 0) -> dict:
    """A call's launches: each step's grid pass and its counted patch (one
    a group of up to ``grid_knn._BATCHED_MAX_GROUP`` clouds flat, one a
    cloud cloud by cloud), the style encoder's two FPS and ball queries for
    the batch, and ``blocks`` denoiser-block launches a step
    (``profile_common_torch.denoiser_launches``)."""
    groups = -(-B // grid_knn._BATCHED_MAX_GROUP) if mode == "flat" else B
    want = {"grid_interp": steps * groups, "knn_topk": steps * groups,
            "fps": 2, "ball_query": 2}
    return want | ({"denoiser_block": steps * blocks} if blocks else {})


def run_mode(model, schedule, B: int, steps: int, reps: int, mode: str,
             profiled: bool = False) -> dict:
    cfg, device = model.config, model.device
    n = cfg.total_points
    gen = torch.Generator(device=device).manual_seed(common.SEED)
    src = torch.randn((B, n, 3), generator=gen, device=device) * 0.9
    cond = torch.randn((B, n, 3), generator=gen, device=device) * 0.9

    def run():
        out = guided_sample_loop(model, schedule, src, cond,
                                 num_inference_steps=steps,
                                 guidance_scale=cfg.guidance_scale,
                                 generator=gen)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out
    flat_ok = grid_knn._batched_grid_ok if mode == "flat" else (
        lambda *a, **k: False)
    capture.release()
    with common.patched(grid_knn, "_batched_grid_ok", flat_ok):
        t0 = time.perf_counter()
        out = run()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run()
        second_s = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run()
            times.append(time.perf_counter() - t0)
        launches = common.launches_of(run)
        profile = common.device_kernels(run) \
            if profiled and device.type == "cuda" else None
    capture.release()
    if tuple(out.shape) != (B, n, 3) or not torch.isfinite(out).all():
        raise RuntimeError(f"B={B} {mode}: output not finite or not "
                           f"[{B}, {n}, 3]")
    want = launches_want(mode, B, steps, common.denoiser_launches(model))
    if device.type == "cuda" and launches != want:
        raise RuntimeError(f"B={B} {mode}: a call launched {launches} != "
                           f"{want}")
    dt = statistics.median(times)
    return {"s_per_batch": dt, "s_per_cloud": dt / B,
            "points_per_s": B * n / dt, "spread": common.spread(times),
            "runs_s": times, "first_s": first_s, "second_s": second_s,
            "launches": launches, "profile": profile}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("steps", nargs="?", type=int, default=50)
    parser.add_argument("batches", nargs="*", type=int, default=[1, 2, 4, 8])
    parser.add_argument("--reps", type=int, default=3)
    common.script_args(parser)
    args = parser.parse_args(argv)
    model = common.random_model(args.device, common.config_of(args))
    device = model.device
    schedule = make_schedule(model.config).to(device)
    card = common.device_name(device)
    cloud_only = bool(os.environ.get("PCST_FORCE_LAXMAP"))
    print(f"device={card} steps={args.steps} N={model.config.total_points}"
          + (" (PCST_FORCE_LAXMAP: cloud by cloud only)" if cloud_only
             else ""), flush=True)
    results: dict = {}
    for B in args.batches:
        modes = ["cloud"] if cloud_only else ["flat"] + (
            ["cloud"] if B > 1 else [])
        for mode in modes:
            r = results.setdefault(mode, {})[B] = run_mode(
                model, schedule, B, args.steps, args.reps, mode,
                B == args.batches[0])
            print(f"B={B} {mode}: {r['s_per_batch']:.4f} s/batch = "
                  f"{r['s_per_cloud']:.4f} s/cloud, {r['points_per_s']:,.0f} "
                  f"points/s (spread {100 * r['spread']:.1f}%; first call "
                  f"{r['first_s']:.2f} s, second (capture) "
                  f"{r['second_s']:.2f} s); launches {r['launches']}",
                  flush=True)
            if r["profile"]:
                common.print_kernels(f"[sampler B={B} {mode}]",
                                     f"one replayed call of {args.steps} "
                                     "steps", r["profile"], card)
    for mode, by_b in results.items():
        first = min(by_b)
        for B, r in by_b.items():
            if B != first:
                gain = r["points_per_s"] / by_b[first]["points_per_s"]
                print(f"{mode} B={B} throughput vs B={first}: {gain:.3f}x")
    return {"device": card, "steps": args.steps, "by_mode": results}


if __name__ == "__main__":
    main()
