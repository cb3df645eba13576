"""Preprocess CLI: pair sim/real files, split, hierarchical voxel pipeline
(counterpart of ``pointcloud_style_transfer_tpu/cli/preprocess.py``; numpy
only, so it runs on the host whatever the device).

Files are paired by sorted order truncated to the smaller count, split
80/10/10 with the fixed seed-42 shuffle, normalised and voxel-downsampled
pair by pair, and summarised in ``preprocessing_config.json``:

    python -m pointcloud_style_transfer_torch.cli.preprocess \\
        --sim_dir sim/ --real_dir real/ --output_dir datasets/processed
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..data.preprocessing import PointCloudPreprocessor
from ..device import resolve_device
from ..utils.logger import get_logger
from ._common import load_point_cloud


def split_indices(n: int, train_ratio: float = 0.8, seed: int = 42):
    """80/10/10 split matching sklearn train_test_split(shuffle=True,
    random_state=42) semantics: a seeded permutation, with the tail halved
    between val and test."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_temp = int(round(n * (1.0 - train_ratio)))
    n_temp = min(max(n_temp, 0), n)
    train = perm[:n - n_temp].tolist()
    temp = perm[n - n_temp:]
    rng2 = np.random.RandomState(seed)
    perm2 = rng2.permutation(len(temp))
    n_test = len(temp) // 2
    val = temp[perm2[:len(temp) - n_test]].tolist()
    test = temp[perm2[len(temp) - n_test:]].tolist()
    return {"train": train, "val": val, "test": test}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Preprocess point cloud data for the hierarchical model")
    parser.add_argument("--sim_dir", type=str, required=True)
    parser.add_argument("--real_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str,
                        default="datasets/processed_hierarchical")
    parser.add_argument("--total_points", type=int, default=120000)
    parser.add_argument("--global_points", type=int, default=30000)
    parser.add_argument("--train_ratio", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; the pipeline itself is "
                             "numpy on the host")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    log = get_logger("preprocess")
    os.makedirs(args.output_dir, exist_ok=True)
    for split in ("train", "val", "test"):
        os.makedirs(os.path.join(args.output_dir, split), exist_ok=True)

    sim_files = sorted(glob.glob(os.path.join(args.sim_dir, "*")))
    real_files = sorted(glob.glob(os.path.join(args.real_dir, "*")))
    if len(sim_files) != len(real_files):
        log.warning("sim (%d) != real (%d) file counts; truncating",
                    len(sim_files), len(real_files))
        m = min(len(sim_files), len(real_files))
        sim_files, real_files = sim_files[:m], real_files[:m]
    if not sim_files:
        log.error("no input files found")
        return 1
    log.info("Found %d paired files", len(sim_files))

    pre = PointCloudPreprocessor(total_points=args.total_points,
                                 global_points=args.global_points,
                                 seed=args.seed)
    splits = split_indices(len(sim_files), args.train_ratio, args.seed)

    counts = {}
    for split_name, idxs in splits.items():
        log.info("Processing %s split (%d files)", split_name, len(idxs))
        done = 0
        for i, idx in enumerate(idxs):
            try:
                sim = load_point_cloud(sim_files[idx])
                real = load_point_cloud(real_files[idx])
                pre.save_hierarchical_data(
                    sim, real, os.path.join(args.output_dir, split_name),
                    f"{split_name}_{i:04d}")
                done += 1
            except Exception as e:  # skip bad pairs (reference :107-109)
                log.error("Error processing pair %s / %s: %s",
                          sim_files[idx], real_files[idx], e)
        counts[split_name] = done

    with open(os.path.join(args.output_dir, "preprocessing_config.json"),
              "w") as f:
        json.dump({
            "total_points": args.total_points,
            "global_points": args.global_points,
            "normalization_method": "isotropic",
            "train_files": counts.get("train", 0),
            "val_files": counts.get("val", 0),
            "test_files": counts.get("test", 0),
        }, f, indent=4)
    log.info("Preprocessing complete -> %s", args.output_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
