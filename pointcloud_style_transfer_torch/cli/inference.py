"""Inference CLI: hierarchical CFG style transfer for one source/reference
pair (counterpart of ``pointcloud_style_transfer_tpu/cli/inference.py``).

Loads the checkpoint's config and (EMA) weights, normalises both clouds,
runs the guided sampler on the chosen device (default ``cuda``), denormalises
with the SOURCE's parameters and saves float32 ``.npy``.

    python -m pointcloud_style_transfer_torch.cli.inference \\
        --checkpoint model.pt --source sim.npy --reference real.npy \\
        --output out.npy [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from ..data.preprocessing import (denormalize_point_cloud,
                                  normalize_point_cloud)
from ..device import resolve_device
from ..models import guided_sample_loop, make_schedule
from ..utils.checkpoint import load_for_inference
from ._common import load_point_cloud

logger = logging.getLogger("pointcloud_style_transfer_torch.inference")


class DiffusionInference:
    """Inference engine for one device (default ``cuda``; raises without a
    card unless ``device="cpu"``). Its random draws come from one
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, checkpoint_path: str, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.config, self.model = load_for_inference(checkpoint_path,
                                                     self.device)
        self.schedule = make_schedule(self.config).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        logger.info("Inference engine ready on %s", self.device)

    def transfer_style_hierarchical(self, source_points: np.ndarray,
                                    reference_points: np.ndarray,
                                    num_steps: int = 50,
                                    guidance_scale: float = 7.5) -> np.ndarray:
        t0 = time.perf_counter()
        src_norm, src_params = normalize_point_cloud(source_points)
        ref_norm, _ = normalize_point_cloud(reference_points)
        src = torch.from_numpy(src_norm)[None].to(self.device)
        ref = torch.from_numpy(ref_norm)[None].to(self.device)
        out = guided_sample_loop(
            self.model, self.schedule, src, ref,
            num_inference_steps=num_steps, guidance_scale=guidance_scale,
            generator=self.generator)
        result = denormalize_point_cloud(out[0].cpu().numpy(), src_params)
        logger.info("Style transfer finished in %.2fs (%d points)",
                    time.perf_counter() - t0, len(result))
        return result.astype(np.float32)

    def process_file(self, source_path: str, reference_path: str,
                     output_path: str, num_steps: int = 50,
                     guidance_scale: float = 7.5) -> None:
        sim = load_point_cloud(source_path)
        real = load_point_cloud(reference_path)
        transferred = self.transfer_style_hierarchical(
            sim, real, num_steps, guidance_scale)
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        np.save(output_path, transferred.astype(np.float32))
        logger.info("Saved transferred cloud to %s", output_path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Hierarchical point-cloud style transfer inference")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="port checkpoint: a .pt file or a training "
                             "checkpoint directory (e.g. best_model/)")
    parser.add_argument("--source", type=str, required=True)
    parser.add_argument("--reference", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--num_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    try:
        engine = DiffusionInference(args.checkpoint, seed=args.seed,
                                    device=resolve_device(args.device))
        engine.process_file(args.source, args.reference, args.output,
                            args.num_steps, args.guidance_scale)
    except Exception:  # CLI boundary: report and return a failing status
        logger.exception("Inference failed")
        return 1
    print("Inference completed successfully!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
