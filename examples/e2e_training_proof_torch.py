"""End-to-end training proof of the PyTorch port: the counterpart of
``examples/e2e_training_proof.py``, with the same arguments and defaults.

It trains ``Config()`` widths on paired synthetic LiDAR scenes
(``data/synthetic.py``: a clean simulator-style sampling, "sim", and a
beam-ring sweep with range noise, "real", of one scene) long enough to show
the loss falling, samples transfers from the best checkpoint's EMA weights
and scores that checkpoint with ``cli.test``, plain and with ``--fast``:

1. 64 pairs of 4,096 points from ``np.random.default_rng(42)``;
2. ``cli.preprocess`` (the seed-42 80/10/10 split: 51 / 7 / 6 pairs);
3. ``Config`` with the JAX proof's fields, ``create_dataloaders`` and
   ``DiffusionTrainer(resume=False)``; 60 epochs of ``train_one_epoch``,
   ``validate_one_epoch`` (EMA, L1 only) at every 5th epoch and the last,
   each followed by a checkpoint (``best_model`` on improvement);
4. a transfer sample from the EMA weights (``guided_sample_loop``);
5. ``cli.test`` on ``best_model``'s test split, then again with ``--fast``.

On the card the steps and the samplers run as CUDA graphs
(``models/capture.py``); the script releases the trainer's graphs before
the tests and reports each part's peak memory, the graphs captured, each
epoch's learning rate beside the rate one of its optimizer updates applied
(recovered from the parameters and the optimizer state around it), and the
validation batches ``validate_one_epoch`` left out as non-finite.

    python examples/e2e_training_proof_torch.py \\
        --workdir build/e2e_proof_torch \\
        --outdir docs/artifacts/e2e_training_torch

A tiny run on the CPU: ``--device cpu --pairs 10 --points 256
--global_points 64 --epochs 3 --num_inference_steps 5 --test_samples 2``.

Artifacts written to ``--outdir``: ``loss_curve.json`` (and ``.png`` where
matplotlib imports), ``samples/{source,style_reference,transferred}.npy``
(and ``transfer.png``), ``test_<stamp>/`` and ``fast_mode/test_<stamp>/``
(``test_config.json``, ``test_results.json``). ``main`` returns the run's
readings as a dict.

``chip_smoke.py`` prints each artifact as a line (``artifact_lines``:
``[proof] artifact <path> <payload>``, a JSON file's content or an
``.npy`` file's bytes in base64); ``--from_log <log>`` writes the
artifacts of such a log into ``--outdir`` and does nothing else.
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

EXPERIMENT = "e2e_proof"


def ellipsoid_shell(rng, n):
    """Smooth ellipsoid shell with random radii + soft bumps."""
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    radii = rng.uniform(0.6, 1.3, 3).astype(np.float32)
    pts = v * radii
    w = rng.uniform(1.5, 3.0, 3).astype(np.float32)
    pts *= (1.0 + 0.15 * np.sin(pts @ w)[:, None]).astype(np.float32)
    return pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)


def box_surface(rng, n):
    """Axis-aligned box surface: flat faces + sharp edges (the 'style')."""
    dims = rng.uniform(0.7, 1.4, 3).astype(np.float32)
    face = rng.integers(0, 6, n)
    u = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts = u * dims
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0).astype(np.float32)
    pts[np.arange(n), axis] = sign * dims[axis]
    return pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)


def write_pairs(raw_dir: str, pairs: int, points: int, scene: str) -> None:
    """``pairs`` sim/real clouds from one ``default_rng(42)`` stream into
    ``raw_dir/{sim,real}/shape_<i>.npy``, as the JAX proof writes them."""
    from pointcloud_style_transfer_torch.data.synthetic import \
        lidar_scene_pair
    rng = np.random.default_rng(42)
    for side in ("sim", "real"):
        os.makedirs(os.path.join(raw_dir, side), exist_ok=True)
    for i in range(pairs):
        if scene == "lidar":
            sim, real = lidar_scene_pair(rng, points)
        else:
            sim, real = ellipsoid_shell(rng, points), box_surface(rng, points)
        np.save(os.path.join(raw_dir, "sim", f"shape_{i:03d}.npy"), sim)
        np.save(os.path.join(raw_dir, "real", f"shape_{i:03d}.npy"), real)


class StepProbe:
    """Stands in for ``trainer.train_step``: counts the mini-steps and, at
    each epoch's first optimizer update (the accumulation's last mini-step;
    the counters start at 0), keeps the learning rate that update applied,
    recovered on the device without a host read: the update is ``-lr *
    (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)`` with the moments
    it stored, so ``lr = -<dp, u> / <u, u>``. Also its root mean square
    step ``|dp|``, and each epoch's host seconds inside ``train_step`` (the
    draws, the key, the input copies and the replay's launch; the rest of
    an epoch is the loader's and the batches' copies)."""

    def __init__(self, trainer):
        self.trainer, self.inner = trainer, trainer.train_step
        self.calls, self.epoch = 0, None
        self.applied: dict = {}   # epoch -> (lr, rms of dp), 0-d tensors
        self.step_s: dict = {}    # epoch -> host seconds in train_step
        trainer.train_step = self

    def __call__(self, sim, real, lr, draws=None):
        opt = self.trainer.optimizer
        plist = [self.trainer.params[k] for k in opt.names]
        probe = ((self.calls + 1) % opt.every_k == 0
                 and self.epoch not in self.applied)
        before = opt._flat(plist).double() if probe else None
        t0 = time.perf_counter()
        out = self.inner(sim, real, lr, draws)
        self.step_s[self.epoch] = (self.step_s.get(self.epoch, 0.0)
                                   + time.perf_counter() - t0)
        self.calls += 1
        if probe:
            dp = opt._flat(plist).double() - before
            b1c = 1 - opt.b1 ** opt.count.double()
            b2c = 1 - opt.b2 ** opt.count.double()
            u = ((opt.mu.double() / b1c)
                 / (torch.sqrt(opt.nu.double() / b2c) + opt.eps)
                 + opt.weight_decay * before)
            self.applied[self.epoch] = (-(dp * u).sum() / (u * u).sum(),
                                        dp.pow(2).mean().sqrt())
        return out


class ValProbe:
    """Stands in for ``trainer.eval_step``: keeps each batch's total loss,
    which ``validate_one_epoch`` reads anyway, so that the batches it left
    out as non-finite can be counted."""

    def __init__(self, trainer):
        self.inner, self.totals = trainer.eval_step, []
        trainer.eval_step = self

    def __call__(self, sim, real, draws=None):
        out = self.inner(sim, real, draws)
        self.totals.append(out["total_loss"])
        return out

    def dropped(self) -> int:
        """Non-finite totals since the last call."""
        n = sum(not np.isfinite(float(t)) for t in self.totals)
        self.totals = []
        return n


def peak_mib(device: torch.device) -> float | None:
    """The peak allocated device memory since the last reset, in MiB (None
    on the CPU); then resets it."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    return peak


def plot_curve(history: dict, title: str, path: str) -> bool:
    """The loss curve as a PNG; False where matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(history["train"], label="train (total)")
    ax.plot(history["train_l1"], label="train L1 (noise)", alpha=0.8)
    ax.plot(history["train_chamfer"],
            label="train Chamfer(pred_x0) (raw; x0.1 in total)", alpha=0.6)
    ax.plot(history["val_epochs"], history["val"], "o-",
            label="val (EMA, L1-only)")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


ARTIFACT_TAG = "[proof] artifact "


def artifact_lines(outdir: str, npy: bool = True) -> list:
    """One line per ``.json`` (and, with ``npy``, ``.npy``) file under
    ``outdir``: the tag, the path relative to ``outdir``, the payload."""
    lines = []
    for path in sorted(glob.glob(os.path.join(outdir, "**", "*"),
                                 recursive=True)):
        rel = os.path.relpath(path, outdir)
        if path.endswith(".json"):
            with open(path) as f:
                payload = json.dumps(json.load(f))
        elif npy and path.endswith(".npy"):
            with open(path, "rb") as f:
                payload = base64.b64encode(f.read()).decode("ascii")
        else:
            continue
        lines.append(f"{ARTIFACT_TAG}{rel} {payload}")
    return lines


def unpack_artifacts(log_path: str, outdir: str) -> list:
    """Write the artifacts of ``artifact_lines`` found in a log into
    ``outdir``; returns their paths."""
    written = []
    with open(log_path) as f:
        for line in f:
            if not line.startswith(ARTIFACT_TAG):
                continue
            rel, payload = line[len(ARTIFACT_TAG):].rstrip("\n").split(" ", 1)
            path = os.path.join(outdir, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if rel.endswith(".json"):
                with open(path, "w") as out:
                    json.dump(json.loads(payload), out, indent=2)
            else:
                with open(path, "wb") as out:
                    out.write(base64.b64decode(payload))
            written.append(path)
    return written


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", default="build/e2e_proof_torch")
    parser.add_argument("--outdir",
                        default="docs/artifacts/e2e_training_torch")
    parser.add_argument("--pairs", type=int, default=64)
    parser.add_argument("--points", type=int, default=4096)
    parser.add_argument("--global_points", type=int, default=1024)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--scene", choices=("lidar", "shapes"),
                        default="lidar")
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--test_samples", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--from_log", default=None,
                        help="write the artifacts a chip_smoke.py log "
                             "printed into --outdir, and nothing else")
    args = parser.parse_args(argv)
    if args.from_log:
        return {"written": unpack_artifacts(args.from_log, args.outdir)}

    from pointcloud_style_transfer_torch.cli import preprocess as pre_cli
    from pointcloud_style_transfer_torch.cli import test as test_cli
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.data import create_dataloaders
    from pointcloud_style_transfer_torch.device import resolve_device
    from pointcloud_style_transfer_torch.models import (capture,
                                                        guided_sample_loop)
    from pointcloud_style_transfer_torch.training import DiffusionTrainer
    from pointcloud_style_transfer_torch.training.ema import call_with_params
    from pointcloud_style_transfer_torch.training.lr_schedule import \
        lr_for_epoch
    from pointcloud_style_transfer_torch.utils.visualization import \
        plot_style_transfer_result

    device = resolve_device(args.device)
    wd, out = args.workdir, args.outdir
    os.makedirs(os.path.join(out, "samples"), exist_ok=True)
    seconds, peaks, captures = {}, {}, {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n_captures = len(capture.CAPTURES)

    def part(name: str, t0: float) -> None:
        nonlocal n_captures
        seconds[name] = time.perf_counter() - t0
        peaks[name] = peak_mib(device)
        captures[name] = len(capture.CAPTURES) - n_captures
        n_captures = len(capture.CAPTURES)

    print(f"[1/5] generating {args.pairs} structured {args.scene} pairs ...",
          flush=True)
    t0 = time.perf_counter()
    write_pairs(os.path.join(wd, "raw"), args.pairs, args.points, args.scene)

    print("[2/5] preprocessing (seed-42 80/10/10 split) ...", flush=True)
    rc = pre_cli.main(["--sim_dir", f"{wd}/raw/sim", "--real_dir",
                       f"{wd}/raw/real", "--output_dir", f"{wd}/processed",
                       "--total_points", str(args.points),
                       "--global_points", str(args.global_points),
                       "--device", args.device])
    if rc != 0:
        raise RuntimeError(f"cli.preprocess returned {rc}")
    part("data", t0)

    print(f"[3/5] training {args.epochs} epochs ...", flush=True)
    t0 = time.perf_counter()
    config = Config(
        experiment_name=EXPERIMENT,
        processed_data_dir=f"{wd}/processed",
        checkpoint_dir=f"{wd}/checkpoints",
        log_dir=f"{wd}/logs", result_dir=f"{wd}/results",
        total_points=args.points, global_points=args.global_points,
        num_epochs=args.epochs, val_interval=5, warmup_epochs=3,
        batch_size=args.batch_size, save_interval=10)
    train_loader, val_loader = create_dataloaders(config)
    trainer = DiffusionTrainer(config, resume=False, device=device)
    steps, vals = StepProbe(trainer), ValProbe(trainer)

    history = {"train": [], "train_l1": [], "train_chamfer": [],
               "val_epochs": [], "val": []}
    epoch_s, val_dropped = [], []
    for epoch in range(config.num_epochs):
        steps.epoch = epoch
        te = time.perf_counter()
        tr = trainer.train_one_epoch(train_loader, epoch)
        epoch_s.append(time.perf_counter() - te)
        history["train"].append(float(tr))
        terms = trainer.last_train_terms
        history["train_l1"].append(float(terms.get("noise_loss", 0.0)))
        history["train_chamfer"].append(
            float(terms.get("chamfer_loss", 0.0)))
        if epoch % config.val_interval == 0 or epoch == config.num_epochs - 1:
            vl = trainer.validate_one_epoch(val_loader, epoch)
            val_dropped.append(vals.dropped())
            history["val_epochs"].append(epoch)
            history["val"].append(float(vl))
            is_best = vl < trainer.best_val_loss
            if is_best:
                trainer.best_val_loss = vl
            trainer.checkpoint_manager.save(
                trainer.state(), epoch, config, is_best=is_best,
                best_val_loss=trainer.best_val_loss)
    with open(f"{out}/loss_curve.json", "w") as f:
        json.dump(history, f, indent=2)
    lr_trace = [{"epoch": e,
                 "lr_for_epoch": lr_for_epoch(
                     e, config.learning_rate, config.warmup_epochs,
                     config.num_epochs, config.min_lr_ratio),
                 "applied": float(lr), "update_rms": float(rms)}
                for e, (lr, rms) in sorted(steps.applied.items())]
    part("train", t0)
    plot_curve(history, f"e2e training proof (port): {args.scene} sim -> "
               f"real style, {args.pairs} pairs, {args.points} pts",
               f"{out}/loss_curve.png")

    print("[4/5] transfer samples ...", flush=True)
    t0 = time.perf_counter()
    batch = next(iter(val_loader))
    src = torch.from_numpy(batch["sim_full"][:1]).to(device)
    ref_style = torch.from_numpy(batch["real_full"][:1]).to(device)
    transferred = call_with_params(
        trainer.model.net, trainer.ema_params, guided_sample_loop,
        trainer.model, trainer.schedule, src, ref_style,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=config.guidance_scale,
        generator=torch.Generator(device=device).manual_seed(0))
    clouds = {"source": src[0], "style_reference": ref_style[0],
              "transferred": transferred[0]}
    for name, cloud in clouds.items():
        np.save(f"{out}/samples/{name}.npy", cloud.cpu().numpy())
    plot_style_transfer_result(
        *(clouds[k].cpu().numpy() for k in
          ("source", "transferred", "style_reference")),
        title="source / transferred / style reference",
        save_path=f"{out}/transfer.png")
    mini_steps, step_s = steps.calls, [steps.step_s[e]
                                       for e in range(config.num_epochs)]
    del trainer, steps, vals
    capture.release()  # the trainer's graphs and their pools
    part("samples", t0)

    print("[5/5] test CLI metrics (parity + fast mode) ...", flush=True)
    best = f"{wd}/checkpoints/{EXPERIMENT}/best_model"
    results = {}
    for name, sub, extra in (("test", "", []),
                             ("test_fast", "fast_mode", ["--fast"])):
        t0 = time.perf_counter()
        test_out = os.path.join(out, sub) if sub else out
        known = set(glob.glob(os.path.join(test_out, "test_*")))
        rc = test_cli.main([
            "--checkpoint", best, "--test_data", f"{wd}/processed/test",
            "--output_dir", test_out, "--num_samples", str(args.test_samples),
            "--num_inference_steps", str(args.num_inference_steps),
            "--compute_all_metrics", "--device", args.device, *extra])
        if rc != 0:
            raise RuntimeError(f"cli.test {' '.join(extra)} returned {rc}")
        (run,) = set(glob.glob(os.path.join(test_out, "test_*"))) - known
        with open(os.path.join(run, "test_results.json")) as f:
            results[name] = {"dir": run, **json.load(f)}
        part(name, t0)
    print(f"done - artifacts in {out}/", flush=True)
    return {"history": history, "val_dropped": val_dropped,
            "lr": lr_trace, "epoch_seconds": epoch_s,
            "step_seconds": step_s,
            "mini_steps": mini_steps,
            "seconds": seconds, "peak_mib": peaks, "captures": captures,
            "tests": results, "best_model": best,
            "processed": f"{wd}/processed", "outdir": out}


if __name__ == "__main__":
    main()
