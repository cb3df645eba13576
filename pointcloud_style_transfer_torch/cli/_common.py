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
