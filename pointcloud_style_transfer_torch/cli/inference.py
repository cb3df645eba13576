"""Inference CLI: hierarchical CFG style transfer for one source/reference
pair, or for every cloud of a directory in batches (counterpart of
``pointcloud_style_transfer_tpu/cli/inference.py``).

Loads the checkpoint's config and (EMA) weights, normalises both clouds,
runs the guided sampler on the chosen device (default ``cuda``), denormalises
with the SOURCE's parameters and saves float32 ``.npy``. ``--fast`` runs the
coarse displacement-field sampler (``guided_sample_loop_coarse``): an
approximation of the per-step mode, not the same output.

    python -m pointcloud_style_transfer_torch.cli.inference \\
        --checkpoint model.pt --source sim.npy --reference real.npy \\
        --output out.npy [--fast] [--visualize] [--device cpu]
    python -m pointcloud_style_transfer_torch.cli.inference \\
        --checkpoint model.pt --source_dir sims/ --reference real.npy \\
        --output_dir out/ --batch_size 2

``--visualize`` also writes a 3-panel plot beside a single output
(``out.png``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import logging
import os
import sys
import time

import numpy as np
import torch

from ..data.preprocessing import (PointCloudPreprocessor,
                                  denormalize_point_cloud,
                                  normalize_point_cloud)
from ..device import resolve_device
from ..models import (guided_sample_loop, guided_sample_loop_coarse,
                      make_schedule)
from ..utils.cache import enable_compilation_cache
from ..utils.checkpoint import load_for_inference
from ..utils.visualization import plot_style_transfer_result
from ._common import load_point_cloud

logger = logging.getLogger("pointcloud_style_transfer_torch.inference")


class DiffusionInference:
    """Inference engine for one device (default ``cuda``; raises without a
    card unless ``device="cpu"``). Its random draws come from one
    ``torch.Generator`` seeded with ``seed``. ``fast`` selects the coarse
    displacement-field sampler: the DDIM trajectory runs at coarse
    resolution and one kNN interpolates the final displacement."""

    def __init__(self, checkpoint_path: str, seed: int = 0,
                 device: str | torch.device | None = None,
                 fast: bool = False):
        self.device = resolve_device(device)
        self.config, self.model = load_for_inference(checkpoint_path,
                                                     self.device)
        self.schedule = make_schedule(self.config).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.fast = fast
        self._sampler = guided_sample_loop_coarse if fast \
            else guided_sample_loop
        logger.info("Inference engine ready on %s%s", self.device,
                    ", fast displacement mode" if fast else "")

    def transfer_style_hierarchical(self, source_points: np.ndarray,
                                    reference_points: np.ndarray,
                                    num_steps: int = 50,
                                    guidance_scale: float = 7.5) -> np.ndarray:
        t0 = time.perf_counter()
        src_norm, src_params = normalize_point_cloud(source_points)
        ref_norm, _ = normalize_point_cloud(reference_points)
        src = torch.from_numpy(src_norm)[None].to(self.device)
        ref = torch.from_numpy(ref_norm)[None].to(self.device)
        out = self._sampler(
            self.model, self.schedule, src, ref,
            num_inference_steps=num_steps, guidance_scale=guidance_scale,
            generator=self.generator)
        result = denormalize_point_cloud(out[0].cpu().numpy(), src_params)
        logger.info("Style transfer finished in %.2fs (%d points)",
                    time.perf_counter() - t0, len(result))
        return result.astype(np.float32)

    def process_file(self, source_path: str, reference_path: str,
                     output_path: str, num_steps: int = 50,
                     guidance_scale: float = 7.5,
                     visualize: bool = False) -> None:
        sim = load_point_cloud(source_path)
        real = load_point_cloud(reference_path)
        transferred = self.transfer_style_hierarchical(
            sim, real, num_steps, guidance_scale)
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        np.save(output_path, transferred.astype(np.float32))
        logger.info("Saved transferred cloud to %s", output_path)
        if visualize:
            vis_path = os.path.splitext(output_path)[0] + ".png"
            if plot_style_transfer_result(sim, transferred, real,
                                          title="Style Transfer Result",
                                          save_path=vis_path):
                logger.info("Visualization saved to %s", vis_path)

    def process_directory(self, source_dir: str, reference: str | None,
                          output_dir: str, batch_size: int = 1,
                          num_steps: int = 50, guidance_scale: float = 7.5,
                          reference_dir: str | None = None) -> int:
        """Batched inference over every cloud in ``source_dir`` (sorted by
        name), ``batch_size`` pairs at a time through one sampler call, each
        cloud resampled to the checkpoint's ``total_points``; a ragged last
        batch is padded with its last pair. The next batch's files load on a
        thread while the device works. References: matched by file name
        from ``reference_dir`` if given, else the single ``reference`` cloud
        styles every source. Saves ``<name>_transferred.npy`` into
        ``output_dir`` and returns the number of clouds processed."""
        files = sorted(sum((glob.glob(os.path.join(source_dir, p))
                            for p in ("*.npy", "*.txt", "*.npz", "*.pt")), []))
        if not files:
            raise FileNotFoundError(f"no point clouds in {source_dir}")
        os.makedirs(output_dir, exist_ok=True)
        pre = PointCloudPreprocessor(total_points=self.config.total_points,
                                     global_points=self.config.global_points)

        def load_pair(path):
            src = pre._resample_to_total(load_point_cloud(path))
            ref_path = reference if reference_dir is None else os.path.join(
                reference_dir, os.path.basename(path))
            ref = pre._resample_to_total(load_point_cloud(ref_path))
            s_n, s_p = normalize_point_cloud(src)
            r_n, _ = normalize_point_cloud(ref)
            return path, s_n, r_n, s_p

        def load_batch(batch_files):
            return [load_pair(p) for p in batch_files]

        batches = [files[i:i + batch_size]
                   for i in range(0, len(files), batch_size)]
        t0 = time.perf_counter()
        done = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
            nxt = ex.submit(load_batch, batches[0])
            for bi in range(len(batches)):
                pairs = nxt.result()
                if bi + 1 < len(batches):
                    nxt = ex.submit(load_batch, batches[bi + 1])
                pad = batch_size - len(pairs)
                padded = pairs + pairs[-1:] * pad
                src = torch.from_numpy(np.stack([p[1] for p in padded]))
                ref = torch.from_numpy(np.stack([p[2] for p in padded]))
                out = self._sampler(
                    self.model, self.schedule, src.to(self.device),
                    ref.to(self.device), num_inference_steps=num_steps,
                    guidance_scale=guidance_scale, generator=self.generator)
                out = out.cpu().numpy()  # waits for the device
                for j, (path, _, _, s_params) in enumerate(pairs):
                    res = denormalize_point_cloud(out[j], s_params)
                    name = os.path.splitext(os.path.basename(path))[0]
                    np.save(os.path.join(output_dir,
                                         f"{name}_transferred.npy"),
                            res.astype(np.float32))
                    done += 1
                logger.info("batch %d/%d done (%d clouds, %.2fs total)",
                            bi + 1, len(batches), done,
                            time.perf_counter() - t0)
        return done


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Hierarchical point-cloud style transfer inference")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="port checkpoint: a .pt file or a training "
                             "checkpoint directory (e.g. best_model/)")
    parser.add_argument("--source", type=str, default=None)
    parser.add_argument("--reference", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--source_dir", type=str, default=None,
                        help="batch mode: process every cloud in this dir")
    parser.add_argument("--reference_dir", type=str, default=None,
                        help="batch mode: per-source reference matched by "
                             "filename (default: --reference for all)")
    parser.add_argument("--output_dir", type=str, default="inference_out")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--fast", action="store_true",
                        help="coarse displacement-field sampler: the DDIM "
                             "trajectory runs at global_points resolution "
                             "and one kNN upsamples the final displacement "
                             "(approximate)")
    parser.add_argument("--visualize", action="store_true",
                        help="also save a 3-panel plot beside --output")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    enable_compilation_cache()
    logging.basicConfig(level=logging.INFO)

    if args.source_dir is None and not (args.source and args.reference
                                        and args.output):
        parser.error("either --source_dir or all of --source/--reference/"
                     "--output are required")
    if args.source_dir is not None and not (args.reference
                                            or args.reference_dir):
        parser.error("batch mode needs --reference or --reference_dir")

    try:
        engine = DiffusionInference(args.checkpoint, seed=args.seed,
                                    device=resolve_device(args.device),
                                    fast=args.fast)
        if args.source_dir is not None:
            n = engine.process_directory(
                args.source_dir, args.reference, args.output_dir,
                batch_size=args.batch_size, num_steps=args.num_steps,
                guidance_scale=args.guidance_scale,
                reference_dir=args.reference_dir)
            print(f"Inference completed successfully! ({n} clouds)")
            return 0
        engine.process_file(args.source, args.reference, args.output,
                            args.num_steps, args.guidance_scale,
                            visualize=args.visualize)
    except Exception:  # CLI boundary: report and return a failing status
        logger.exception("Inference failed")
        return 1
    print("Inference completed successfully!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
