"""End-to-end demo of the PyTorch port on synthetic LiDAR-like data (no
dataset needed): the counterpart of ``examples/demo_synthetic.py``, with
its arguments and defaults.

Generates paired sim/real scenes (the JAX demo's ground plane + boxes +
sensor noise, ``lidar_like``), preprocesses them (``cli.preprocess``),
trains for a few epochs (``DiffusionTrainer``), runs the style transfer on
one pair (``cli.inference``'s ``DiffusionInference``) and the bidirectional
evaluation, sim -> real and real -> sim, of the trained model on the test
split (``cli.test`` with every metric), all in-process: the whole
framework in one script.

  python examples/demo_synthetic_torch.py --workdir build/pcst_demo \\
      --epochs 10 [--device cpu] [--config FIELD=VALUE ...]

(The JAX demo writes to /tmp/pcst_demo by default; this one writes inside
the checkout, under ``build/``.) ``main`` returns the outputs' paths, the
test metrics and each part's seconds.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402


def lidar_like(rng, n, noise):
    """Ground plane + boxes + sensor noise."""
    n_ground = n // 2
    ground = np.stack([rng.uniform(-50, 50, n_ground),
                       rng.uniform(-50, 50, n_ground),
                       rng.normal(0, 0.05 + noise, n_ground)], 1)
    rest = n - n_ground
    boxes = []
    for _ in range(12):
        c = rng.uniform(-40, 40, 2)
        w, d, h = rng.uniform(2, 8, 3)
        m = rest // 12
        boxes.append(np.stack([rng.uniform(c[0], c[0] + w, m),
                               rng.uniform(c[1], c[1] + d, m),
                               rng.uniform(0, h, m)], 1))
    pts = np.concatenate([ground] + boxes)[:n]
    return (pts + rng.normal(0, noise, pts.shape)).astype(np.float32)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", default="build/pcst_demo")
    parser.add_argument("--pairs", type=int, default=8)
    parser.add_argument("--points", type=int, default=130000)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--steps", type=int, default=50)
    common.script_args(parser)
    args = parser.parse_args(argv)

    from pointcloud_style_transfer_torch.cli import preprocess as pre_cli
    from pointcloud_style_transfer_torch.cli import test as test_cli
    from pointcloud_style_transfer_torch.cli.inference import \
        DiffusionInference
    from pointcloud_style_transfer_torch.data import create_dataloaders
    from pointcloud_style_transfer_torch.device import resolve_device
    from pointcloud_style_transfer_torch.models import capture
    from pointcloud_style_transfer_torch.training import DiffusionTrainer

    device = resolve_device(args.device)
    wd = args.workdir
    seconds = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    for d in ("raw/sim", "raw/real"):
        os.makedirs(os.path.join(wd, d), exist_ok=True)
    print(f"[1/5] generating {args.pairs} synthetic pairs ...", flush=True)
    for i in range(args.pairs):
        np.save(f"{wd}/raw/sim/cloud_{i:03d}.npy",
                lidar_like(rng, args.points, 0.01))
        np.save(f"{wd}/raw/real/cloud_{i:03d}.npy",
                lidar_like(rng, args.points - 12000, 0.08))
    seconds["data"] = time.perf_counter() - t0

    print("[2/5] preprocessing ...", flush=True)
    cfg = common.config_of(args, experiment_name="demo",
                           processed_data_dir=f"{wd}/processed",
                           checkpoint_dir=f"{wd}/checkpoints",
                           log_dir=f"{wd}/logs",
                           result_dir=f"{wd}/results",
                           num_epochs=args.epochs,
                           val_interval=max(1, args.epochs // 3),
                           warmup_epochs=1)
    t0 = time.perf_counter()
    if pre_cli.main(["--sim_dir", f"{wd}/raw/sim", "--real_dir",
                     f"{wd}/raw/real", "--output_dir", f"{wd}/processed",
                     "--total_points", str(cfg.total_points),
                     "--global_points", str(cfg.global_points),
                     "--device", device.type]):
        raise RuntimeError("cli.preprocess failed")
    seconds["preprocess"] = time.perf_counter() - t0

    print(f"[3/5] training {args.epochs} epochs ...", flush=True)
    t0 = time.perf_counter()
    train_loader, val_loader = create_dataloaders(cfg)
    trainer = DiffusionTrainer(cfg, resume=True, device=device)
    best_val = trainer.train(train_loader, val_loader)
    capture.release()
    seconds["train"] = time.perf_counter() - t0
    best = f"{wd}/checkpoints/demo/best_model"

    print("[4/5] style transfer ...", flush=True)
    t0 = time.perf_counter()
    out = f"{wd}/out/transferred.npy"
    engine = DiffusionInference(best, device=device)
    engine.process_file(f"{wd}/raw/sim/cloud_000.npy",
                        f"{wd}/raw/real/cloud_000.npy", out,
                        visualize=True, num_steps=args.steps)
    seconds["transfer"] = time.perf_counter() - t0

    print("[5/5] bidirectional evaluation (cli.test) ...", flush=True)
    t0 = time.perf_counter()
    if test_cli.main(["--checkpoint", best, "--test_data",
                      f"{wd}/processed/test", "--output_dir",
                      f"{wd}/test_results", "--compute_all_metrics",
                      "--num_inference_steps", str(args.steps),
                      "--device", device.type]):
        raise RuntimeError("cli.test failed")
    seconds["test"] = time.perf_counter() - t0
    capture.release()
    results = sorted(glob.glob(f"{wd}/test_results/test_*/"
                               "test_results.json"))[-1]
    with open(results) as f:
        metrics = json.load(f)["average_metrics"]
    cloud = np.load(out)
    finite = bool(np.isfinite(cloud).all()
                  and np.isfinite(list(metrics.values())).all())
    print(f"done: outputs in {wd}/out/ and {os.path.dirname(results)}; "
          f"transferred {cloud.shape}, best val {best_val:.4f}, metrics "
          + json.dumps({k: round(v, 4) for k, v in metrics.items()})
          + "; seconds " + json.dumps({k: round(v, 1)
                                       for k, v in seconds.items()})
          + f" ({common.device_name(device)})", flush=True)
    return {"transferred": out, "shape": cloud.shape, "best_model": best,
            "best_val": best_val, "test_results": results,
            "metrics": metrics, "finite": finite, "seconds": seconds}


if __name__ == "__main__":
    main()
