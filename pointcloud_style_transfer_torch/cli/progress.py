"""Training-progress visualization (counterpart of
``pointcloud_style_transfer_tpu/cli/progress.py``, the same flags plus
``--device``): run inference with every checkpoint of an experiment (at
most ``--max_checkpoints``, spread evenly) and plot the evolution grid.

    python -m pointcloud_style_transfer_torch.cli.progress \\
        --checkpoint_dir checkpoints/<exp> --source sim.npy \\
        --reference real.npy --output progress.png [--num_steps 50] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..device import resolve_device
from ..utils.cache import enable_compilation_cache
from ..utils.checkpoint import CheckpointManager
from ..utils.logger import get_logger
from ._common import load_point_cloud
from .inference import DiffusionInference


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Visualize style-transfer quality across checkpoints")
    parser.add_argument("--checkpoint_dir", type=str, required=True,
                        help="experiment checkpoint dir (contains "
                             "ckpt_epoch_* subdirs)")
    parser.add_argument("--source", type=str, required=True)
    parser.add_argument("--reference", type=str, required=True)
    parser.add_argument("--output", type=str, default="training_progress.png")
    parser.add_argument("--num_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--max_checkpoints", type=int, default=6)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    enable_compilation_cache()
    device = resolve_device(args.device)

    log = get_logger("progress")
    base, exp = os.path.split(os.path.normpath(args.checkpoint_dir))
    mgr = CheckpointManager(base, exp)
    epochs = mgr.list_epochs()
    if not epochs:
        log.error("no checkpoints in %s", args.checkpoint_dir)
        return 1
    if len(epochs) > args.max_checkpoints:
        sel = np.linspace(0, len(epochs) - 1, args.max_checkpoints)
        epochs = [epochs[int(i)] for i in sel]
    log.info("rendering %d checkpoints: %s", len(epochs), epochs)

    src = load_point_cloud(args.source)
    ref = load_point_cloud(args.reference)

    results = []
    for ep in epochs:
        engine = DiffusionInference(mgr.epoch_dir(ep), device=device)
        out = engine.transfer_style_hierarchical(
            src, ref, args.num_steps, args.guidance_scale)
        results.append((ep, out))
        log.info("epoch %d done", ep)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log.error("matplotlib unavailable; saving npys instead")
        for ep, out in results:
            np.save(f"progress_epoch_{ep:04d}.npy", out)
        return 0

    n = len(results)
    fig = plt.figure(figsize=(4 * n, 8))
    rng = np.random.default_rng(0)

    def sub(pts, k=5000):
        if len(pts) > k:
            pts = pts[rng.choice(len(pts), k, replace=False)]
        return pts

    def panel(pos, pts, cmap, title):
        ax = fig.add_subplot(2, n, pos, projection="3d")
        p = sub(np.asarray(pts))
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=p[:, 2], cmap=cmap, s=0.5)
        ax.set_title(title)
        ax.set_axis_off()

    for i, (ep, out) in enumerate(results):
        panel(i + 1, out, "plasma", f"epoch {ep}")
    panel(n + 1, src, "viridis", "source")
    panel(n + 2, ref, "coolwarm", "style reference")
    plt.tight_layout()
    plt.savefig(args.output, dpi=150, bbox_inches="tight")
    plt.close(fig)
    log.info("saved %s", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
