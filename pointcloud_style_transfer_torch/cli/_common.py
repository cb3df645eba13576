"""Shared CLI helpers."""

from __future__ import annotations

import numpy as np


def load_point_cloud(path: str) -> np.ndarray:
    """Load a point cloud from .npy / .npz (first array) / .txt (comma or
    space separated) / .pt."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[list(z.keys())[0]]
    if path.endswith(".txt"):
        try:
            return np.loadtxt(path, delimiter=",")
        except ValueError:
            return np.loadtxt(path, delimiter=" ")
    if path.endswith(".pt"):
        import torch
        data = torch.load(path, weights_only=True)
        return data.numpy() if hasattr(data, "numpy") else np.asarray(data)
    raise ValueError(f"Unsupported point cloud format: {path}")


def add_config_overrides(parser) -> None:
    """The config flags shared by the training CLIs, and ``--device``."""
    parser.add_argument("--experiment_name", type=str, default=None)
    parser.add_argument("--data_dir", type=str, default=None,
                        help="processed data dir override")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")


def apply_overrides(config, args):
    """The flags given, applied to ``config``."""
    if getattr(args, "experiment_name", None):
        config = config.replace(experiment_name=args.experiment_name)
    if getattr(args, "data_dir", None):
        config = config.replace(processed_data_dir=args.data_dir)
    if getattr(args, "batch_size", None):
        config = config.replace(batch_size=args.batch_size)
    if getattr(args, "num_epochs", None):
        config = config.replace(num_epochs=args.num_epochs)
    if getattr(args, "seed", None) is not None:
        config = config.replace(seed=args.seed)
    return config
