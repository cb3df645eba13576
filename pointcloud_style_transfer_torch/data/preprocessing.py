"""Point-cloud normalisation (numpy; the port's own copy of the JAX
package's ``data/preprocessing.py`` functions)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def normalize_point_cloud(points: np.ndarray, target_range: float = 1.8
                          ) -> Tuple[np.ndarray, Dict]:
    """Center at the mean and scale isotropically so max|coord| ==
    target_range."""
    points = np.asarray(points, dtype=np.float32)
    center = points.mean(axis=0)
    centered = points - center
    max_abs = np.max(np.abs(centered))
    scale = 1.0 if max_abs < 1e-6 else target_range / max_abs
    norm_params = {"center": center, "scale": float(scale),
                   "method": "isotropic", "target_range": float(target_range)}
    return (centered * scale).astype(np.float32), norm_params


def denormalize_point_cloud(points: np.ndarray, norm_params: Dict) -> np.ndarray:
    """Inverse of ``normalize_point_cloud``."""
    return (np.asarray(points) / norm_params["scale"]) + norm_params["center"]
