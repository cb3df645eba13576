"""Test CLI: bidirectional evaluation over a test split (counterpart of
``pointcloud_style_transfer_tpu/cli/test.py``, the same flags plus
``--device`` and ``--seed``).

For every batch of the split it runs sim->real AND real->sim guided
sampling (``guided_sample_loop``, or ``guided_sample_loop_coarse`` with
``--fast``) and, with ``--compute_all_metrics``, scores both directions:
Chamfer, content preservation, Hausdorff, coverage, uniformity, Sinkhorn
EMD and fidelity (``METRIC_KEYS``); the averages over batches go to
``test_results.json``, the flags to ``test_config.json``.

    python -m pointcloud_style_transfer_torch.cli.test \\
        --checkpoint checkpoints/<exp>/best_model --test_data data/test \\
        --batch_size 4 --compute_all_metrics [--save_generated] \\
        [--save_visualizations] [--fast] [--device cpu] [--seed 0]

Random draws (the samplers', the EMD's subsample permutations) come from one
``torch.Generator`` seeded with ``--seed``; ``Tester.test`` also takes them
per batch (``draws``).

Run under ``torchrun --nproc_per_node=<cards>`` (an initialised process
group of more than one rank), the ``Tester`` builds a ``{points: world}``
mesh, as the JAX ``Tester`` does past one device: rank 0 samples and
broadcasts the generated clouds, every rank takes its slice of them for the
point-sharded Chamfer and content terms (the ring, ``parallel/ring.py``),
rank 0 computes the other metrics and broadcasts them, and only rank 0
writes ``test_config.json``, ``test_results.json``, clouds and plots.
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data import Batcher, HierarchicalPointCloudDataset
from ..device import resolve_device
from ..evaluation import (chamfer_distance, coverage_score,
                          earth_mover_distance, fidelity_score,
                          hausdorff_distance, uniformity_score)
from ..models import (guided_sample_loop, guided_sample_loop_coarse,
                      make_schedule)
from ..parallel import POINTS_AXIS, make_mesh
from ..utils.cache import enable_compilation_cache
from ..utils.checkpoint import load_for_inference
from ..utils.logger import get_logger
from ..utils.visualization import plot_style_transfer_result

DIRECTIONS = ("sim_to_real", "real_to_sim")
METRIC_KEYS = (
    "chamfer_sim_to_real", "chamfer_real_to_sim", "content_preservation",
    *(f"{m}_{tag}" for tag in DIRECTIONS
      for m in ("hausdorff", "coverage", "uniformity", "emd", "fidelity")))
EMD_MAX_POINTS = 8192  # earth_mover_distance's subsample size


class Tester:
    """Evaluation of one checkpoint (a training checkpoint directory or a
    ``.pt`` file) on ``device`` (default ``cuda``; raises without a card
    unless ``"cpu"``). ``emd_perms`` keeps, per batch and direction, the EMD
    subsample permutations each call took (None where the cloud was not
    subsampled)."""

    def __init__(self, checkpoint_path: str, output_dir: str = "test_results",
                 seed: int = 0, fast: bool = False,
                 device: str | torch.device | None = None):
        self.logger = get_logger("Tester")
        self.output_dir = output_dir
        self.device = resolve_device(device)
        # more than one rank: the full-resolution Chamfer runs point-sharded
        # over a ring of them; one rank: dense
        self.mesh, self.rank = None, 0
        if dist.is_initialized() and dist.get_world_size() > 1:
            self.mesh = make_mesh({POINTS_AXIS: dist.get_world_size()},
                                  self.device.type)
            self.rank = dist.get_rank()
        if self.rank == 0:
            os.makedirs(output_dir, exist_ok=True)
        self.config, self.model = load_for_inference(checkpoint_path,
                                                     self.device)
        self.schedule = make_schedule(self.config).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # fast mode evaluates the coarse displacement-field sampler
        # (approximate; see cli/inference.py --fast)
        self._sampler = guided_sample_loop_coarse if fast \
            else guided_sample_loop
        self.emd_perms: list = []

    def _emd_perm(self, n: int) -> Optional[torch.Tensor]:
        if n <= EMD_MAX_POINTS:
            return None
        return torch.randperm(n, generator=self.generator, device=self.device)

    @torch.no_grad()
    def test(self, loader, guidance_scale: float = 7.5,
             num_inference_steps: int = 50, compute_all_metrics: bool = True,
             save_generated: bool = False, save_visualizations: bool = False,
             draws: Optional[Sequence[dict]] = None) -> dict:
        """``draws[i]``, when given, holds batch i's draws: ``sim_to_real``
        and ``real_to_sim`` (keyword draws of the sampler) and
        ``emd_sim_to_real`` / ``emd_real_to_sim`` ((pred, target)
        permutations); the others come from the generator, in the JAX
        ``Tester``'s order (both samplers, then each direction's EMD). With
        a mesh every rank calls it with the same loader and returns rank 0's
        metrics."""
        all_metrics = []
        gen_dir = os.path.join(self.output_dir, "generated")
        vis_dir = os.path.join(self.output_dir, "visualizations")
        main = self.rank == 0
        save_generated = save_generated and main
        save_visualizations = save_visualizations and main
        if save_generated:
            os.makedirs(gen_dir, exist_ok=True)
        if save_visualizations:
            os.makedirs(vis_dir, exist_ok=True)

        for batch_idx, batch in enumerate(loader):
            d = draws[batch_idx] if draws is not None else {}
            sim = torch.from_numpy(batch["sim_full"]).to(self.device)
            real = torch.from_numpy(batch["real_full"]).to(self.device)
            B = sim.shape[0]
            out = {}
            for tag, src, cond in (("sim_to_real", sim, real),
                                   ("real_to_sim", real, sim)):
                if main:
                    out[tag] = self._sampler(
                        self.model, self.schedule, src, cond,
                        num_inference_steps=num_inference_steps,
                        guidance_scale=guidance_scale,
                        generator=self.generator, **d.get(tag, {}))
                else:
                    out[tag] = torch.empty_like(src)
                if self.mesh is not None:  # the ring's slices: one cloud
                    dist.broadcast(out[tag], src=0)
            sim_to_real, real_to_sim = out["sim_to_real"], out["real_to_sim"]

            m = {}
            perms = {}
            if compute_all_metrics:
                cd_s2r = chamfer_distance(sim_to_real, real, mesh=self.mesh)
                cd_r2s = chamfer_distance(real_to_sim, sim, mesh=self.mesh)
                content_s2r = chamfer_distance(sim_to_real, sim,
                                               mesh=self.mesh)
                content_r2s = chamfer_distance(real_to_sim, real,
                                               mesh=self.mesh)
                m["chamfer_sim_to_real"] = float(cd_s2r.mean())
                m["chamfer_real_to_sim"] = float(cd_r2s.mean())
                m["content_preservation"] = (
                    float(content_s2r.mean()) + float(content_r2s.mean())) / 2
                for tag, gen, tgt in (("sim_to_real", sim_to_real, real),
                                      ("real_to_sim", real_to_sim, sim)):
                    if not main:
                        continue
                    m[f"hausdorff_{tag}"] = float(
                        hausdorff_distance(gen, tgt).mean())
                    m[f"coverage_{tag}"] = float(coverage_score(gen, tgt))
                    m[f"uniformity_{tag}"] = float(uniformity_score(gen))
                    perms[tag] = d.get(f"emd_{tag}") or (
                        self._emd_perm(gen.shape[1]),
                        self._emd_perm(tgt.shape[1]))
                    m[f"emd_{tag}"] = float(earth_mover_distance(
                        gen, tgt, max_points=EMD_MAX_POINTS,
                        perms=perms[tag]).mean())
                    m[f"fidelity_{tag}"] = fidelity_score(gen, tgt)
            if self.mesh is not None:
                shared = [m]
                dist.broadcast_object_list(shared, src=0)
                m = shared[0]
            self.emd_perms.append(perms)
            all_metrics.append(m)
            self.logger.info("batch %d: %s", batch_idx,
                             {k: round(v, 5) for k, v in m.items()})

            if save_generated:
                for i in range(B):
                    idx = batch_idx * B + i
                    for name, arr in (("sim_to_real", sim_to_real),
                                      ("real_to_sim", real_to_sim),
                                      ("original_sim", sim),
                                      ("original_real", real)):
                        np.save(os.path.join(gen_dir, f"{name}_{idx:04d}.npy"),
                                arr[i].cpu().numpy())

            if save_visualizations and batch_idx < 5:
                for i in range(min(B, 2)):
                    idx = batch_idx * B + i
                    plot_style_transfer_result(
                        sim[i].cpu().numpy(), sim_to_real[i].cpu().numpy(),
                        real[i].cpu().numpy(),
                        title=f"Test Sample {idx} - Sim to Real",
                        save_path=os.path.join(vis_dir,
                                               f"sample_{idx:04d}_s2r.png"))

        average_metrics = {}
        if all_metrics:
            for k in all_metrics[0]:
                vals = [m[k] for m in all_metrics if k in m]
                if vals:
                    average_metrics[k] = float(np.mean(vals))
        return {"average_metrics": average_metrics}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Test point-cloud style transfer model")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--test_data", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="test_results")
    parser.add_argument("--save_generated", action="store_true")
    parser.add_argument("--save_visualizations", action="store_true")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_samples", type=int, default=-1)
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--compute_all_metrics", action="store_true")
    parser.add_argument("--fast", action="store_true",
                        help="evaluate the coarse displacement-field fast "
                             "sampler instead of the per-step one "
                             "(approximate)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    enable_compilation_cache()
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun
        make_mesh(device_type=device.type)  # joins the default group
    main_rank = not dist.is_initialized() or dist.get_rank() == 0

    stamp = [datetime.now().strftime("%Y%m%d_%H%M%S")]
    if dist.is_initialized():  # one run directory for every rank
        dist.broadcast_object_list(stamp, src=0)
    output_dir = os.path.join(args.output_dir, f"test_{stamp[0]}")
    if main_rank:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "test_config.json"), "w") as f:
            json.dump(vars(args), f, indent=2)

    tester = Tester(args.checkpoint, output_dir, seed=args.seed,
                    fast=args.fast, device=device)
    ds = HierarchicalPointCloudDataset(args.test_data, use_hierarchical=True)
    if args.num_samples > 0:
        ds.file_paths = ds.file_paths[:args.num_samples]
    loader = Batcher(ds, batch_size=args.batch_size, shuffle=False,
                     drop_last=False)

    results = tester.test(
        loader, guidance_scale=args.guidance_scale,
        num_inference_steps=args.num_inference_steps,
        compute_all_metrics=args.compute_all_metrics,
        save_generated=args.save_generated,
        save_visualizations=args.save_visualizations)

    if not main_rank:
        return 0
    print("\n" + "=" * 60 + "\nTEST RESULTS SUMMARY\n" + "=" * 60)
    for k, v in results["average_metrics"].items():
        print(f"{k}: {v:.6f}")
    print("=" * 60)
    with open(os.path.join(output_dir, "test_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nDetailed results saved to: "
          f"{os.path.join(output_dir, 'test_results.json')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
