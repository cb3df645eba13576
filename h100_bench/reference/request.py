"""The request's host arithmetic, from the reference repository's
``data/preprocessing.py``: a cloud is centred at its mean and scaled
isotropically so that its largest coordinate is the target range; an
answer goes back by the source's centre and scale.

Imports nothing of the program under test."""

from __future__ import annotations

import numpy as np


def normalize(points: np.ndarray, target_range: float = 1.8):
    """(normalised float32 cloud, (centre, scale))."""
    points = np.asarray(points, dtype=np.float32)
    center = points.mean(axis=0)
    centered = points - center
    max_abs = np.max(np.abs(centered))
    scale = 1.0 if max_abs < 1e-6 else target_range / max_abs
    return (centered * scale).astype(np.float32), (center, float(scale))


def to_normalized(points: np.ndarray, params) -> np.ndarray:
    """An answer in metres back in its source's normalised frame."""
    center, scale = params
    return ((np.asarray(points, np.float64) - center) * scale).astype(
        np.float32)
