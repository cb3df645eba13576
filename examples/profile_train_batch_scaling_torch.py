"""Full-train-step batch scaling on the PyTorch port: the counterpart of
``examples/profile_train_batch_scaling.py``. ``DiffusionTrainer.train_step``
(forward with the hierarchical voxel path and the CFG drop, the loss with
its Chamfer term, the backward, the optimizer and the EMA) at ``Config()``
(120,000 points) for B in {1, 2, 4}.

On the card a mini-step is one CUDA graph (``models/capture.py``, cache
``"step"``): the first call runs eagerly, the second captures, the rest
replay. For each B, after those two: ``--reps`` (10) replayed mini-steps on
the host's clock to a synchronise (ms a mini-step, a cloud, points/s),
the host's part outside the graph (the step's draws, ``step_key`` and the
whole call up to the replay's launch, without a synchronise:
``training/trainer.py::DiffusionTrainer._captured``), and one replay's
device kernels by name under ``torch.profiler`` with the device's busy
share. Each B's trainer and graphs are released before the next.

Usage: python examples/profile_train_batch_scaling_torch.py [B ...]
           [--reps 10] [--device cuda|cpu] [--config FIELD=VALUE ...]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.models import capture  # noqa: E402
from pointcloud_style_transfer_torch.training import \
    DiffusionTrainer  # noqa: E402
from pointcloud_style_transfer_torch.training.trainer import \
    step_draws  # noqa: E402


def host_ms(fn, reps: int) -> float:
    """Median host ms of ``fn`` (no synchronise inside; the device's queue
    drained before each call)."""
    out = []
    for _ in range(reps):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def scale(args, B: int, device: torch.device, work: str) -> dict:
    reps = args.reps
    cfg = common.config_of(
        args, experiment_name=f"batch{B}", batch_size=B,
        checkpoint_dir=os.path.join(work, "checkpoints"),
        log_dir=os.path.join(work, "logs"),
        result_dir=os.path.join(work, "results"),
        processed_data_dir=os.path.join(work, "processed"))
    trainer = DiffusionTrainer(cfg, resume=False, device=device)
    n = cfg.total_points
    gen = torch.Generator(device=device).manual_seed(common.SEED)
    src = torch.randn((B, n, 3), generator=gen, device=device) * 0.9
    cond = torch.randn((B, n, 3), generator=gen, device=device) * 0.9
    lr = trainer.lr_tensor(cfg.learning_rate)

    def step():
        return trainer.train_step(src, cond, lr)
    first = []
    for _ in range(2):  # eager, then captured (and replayed)
        t0 = time.perf_counter()
        terms, _ = step()
        sync(device)
        first.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.isfinite(v) for v in terms.values()):
            raise RuntimeError(f"B={B}: a loss term is not finite: {terms}")
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        sync(device)
        wall.append((time.perf_counter() - t0) * 1e3)
    host = {"key": host_ms(lambda: trainer.step_key("train"), reps),
            "draws": host_ms(lambda: step_draws(
                trainer.model, B, n, n, train=True,
                generator=trainer.generator, device=device), reps),
            "call": host_ms(step, reps)}
    sync(device)
    launches = common.launches_of(step)
    profile = common.device_kernels(step) if device.type == "cuda" \
        else None
    capture.release()
    med = statistics.median(wall)
    return {"first_ms": first[0], "second_ms": first[1], "ms": med,
            "ms_per_cloud": med / B, "points_per_s": B * n / med * 1e3,
            "spread": common.spread(wall), "runs_ms": wall,
            "host_ms": host, "launches": launches, "profile": profile}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("batches", nargs="*", type=int, default=[1, 2, 4])
    parser.add_argument("--reps", type=int, default=10)
    common.script_args(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    card = common.device_name(device)
    print(f"device={card} N={common.config_of(args).total_points}",
          flush=True)
    results = {}
    with tempfile.TemporaryDirectory() as work:
        for B in args.batches:
            capture.release()
            r = results[B] = scale(args, B, device, work)
            h = r["host_ms"]
            print(f"B={B}: {r['ms']:.3f} ms/mini-step (spread "
                  f"{100 * r['spread']:.1f}%) = {r['ms_per_cloud']:.3f} "
                  f"ms/cloud, {r['points_per_s']:,.0f} points/s; first "
                  f"(eager) {r['first_ms']:.1f} ms, second (capture) "
                  f"{r['second_ms']:.1f} ms; host outside the graph: the "
                  f"call {h['call']:.3f} ms (of it the draws {h['draws']:.3f},"
                  f" step_key {h['key']:.3f}); launches {r['launches']}",
                  flush=True)
            if r["profile"]:
                common.print_kernels(f"[train B={B}]", "one replayed "
                                     "mini-step", r["profile"], card)
    first = args.batches[0]
    for B, r in results.items():
        if B != first:
            ratio = r["ms"] / results[first]["ms"]
            print(f"B={B} step time vs B={first}: {ratio:.2f}x (per cloud "
                  f"{ratio * first / B:.2f}x)")
    return {"device": card, "by_batch": results}


if __name__ == "__main__":
    main()
