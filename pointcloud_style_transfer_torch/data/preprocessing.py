"""Offline preprocessing: normalize + hierarchical voxel downsample -> .npz
(the port's own copy of ``pointcloud_style_transfer_tpu/data/
preprocessing.py``; plain numpy, so the same seed gives the same arrays).

Contract (train/infer consistency depends on it):
* normalize: center at the mean, isotropic scale so max-abs == 1.8;
  denormalize inverts with the SOURCE's params;
* voxel downsample: voxel size (range.prod()/target)^(1/3)*1.2,
  representative = closest point to the voxel center, random drop/top-up to
  exactly ``target_size``;
* output files named ``{file_id}_hierarchical.npz`` with the key set
  sim_full/real_full/..._global/..._global_indices/norm params.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def normalize_point_cloud(points: np.ndarray, target_range: float = 1.8
                          ) -> Tuple[np.ndarray, Dict]:
    """Center at the mean and scale isotropically so max|coord| == target_range
    (reference: data/preprocessing.py:21-38)."""
    points = np.asarray(points, dtype=np.float32)
    center = points.mean(axis=0)
    centered = points - center
    max_abs = np.max(np.abs(centered))
    scale = 1.0 if max_abs < 1e-6 else target_range / max_abs
    norm_params = {"center": center, "scale": float(scale),
                   "method": "isotropic", "target_range": float(target_range)}
    return (centered * scale).astype(np.float32), norm_params


def denormalize_point_cloud(points: np.ndarray, norm_params: Dict) -> np.ndarray:
    """Inverse of normalize (reference: data/preprocessing.py:40-42)."""
    return (np.asarray(points) / norm_params["scale"]) + norm_params["center"]


def voxel_grid_downsample(points: np.ndarray, target_size: int,
                          rng: Optional[np.random.Generator] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Closest-to-voxel-center downsample to exactly ``target_size`` points.

    Vectorised reimplementation of the reference's dict-of-voxels loop
    (data/preprocessing.py:45-104): sort by (voxel id, center distance) and
    take the first point of every voxel segment.
    """
    rng = rng or np.random.default_rng()
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if n <= target_size:
        return points, np.arange(n)

    xyz_min = points.min(axis=0)
    xyz_max = points.max(axis=0)
    xyz_range = (xyz_max - xyz_min).astype(np.float64)
    xyz_range[xyz_range < 1e-6] = 1.0
    voxel_size = (xyz_range.prod() / target_size) ** (1 / 3) * 1.2
    if voxel_size < 1e-6:
        voxel_size = 1e-3

    vox = np.floor((points - xyz_min) / voxel_size).astype(np.int64)
    _, inverse = np.unique(vox, axis=0, return_inverse=True)
    center = xyz_min + (vox + 0.5) * voxel_size
    center_dist = ((points - center) ** 2).sum(axis=1)

    order = np.lexsort((center_dist, inverse))
    inv_sorted = inverse[order]
    is_leader = np.ones(n, dtype=bool)
    is_leader[1:] = inv_sorted[1:] != inv_sorted[:-1]
    reps = order[is_leader]

    if len(reps) > target_size:
        sel = rng.choice(reps, target_size, replace=False)
    elif len(reps) < target_size:
        mask = np.ones(n, dtype=bool)
        mask[reps] = False
        pool = np.nonzero(mask)[0]
        extra = rng.choice(pool, min(target_size - len(reps), len(pool)),
                           replace=False)
        sel = np.concatenate([reps, extra])
    else:
        sel = reps

    sel = sel.astype(np.int64)
    return points[sel], sel


def consistent_upsample(coarse_points: np.ndarray, original_points: np.ndarray,
                        coarse_indices: np.ndarray, k: int = 3) -> np.ndarray:
    """kNN inverse-distance upsample (reference: data/preprocessing.py:114-127).
    Uses scipy's cKDTree when available (offline CPU path), pure-numpy
    fallback otherwise."""
    N = len(original_points)
    M = len(coarse_points)
    k = min(k, M)
    result = np.zeros((N, 3), dtype=np.float32)
    result[coarse_indices] = coarse_points
    unknown_mask = np.ones(N, dtype=bool)
    unknown_mask[coarse_indices] = False
    unknown = np.nonzero(unknown_mask)[0]
    if len(unknown) == 0:
        return result
    fit = original_points[coarse_indices]
    try:
        from scipy.spatial import cKDTree
        dist, nbr = cKDTree(fit).query(original_points[unknown], k=k)
        if k == 1:
            dist, nbr = dist[:, None], nbr[:, None]
    except ImportError:  # pure-numpy fallback, chunked
        dist = np.empty((len(unknown), k), np.float64)
        nbr = np.empty((len(unknown), k), np.int64)
        for s in range(0, len(unknown), 4096):
            q = original_points[unknown[s:s + 4096]]
            d = np.linalg.norm(q[:, None, :] - fit[None, :, :], axis=-1)
            part = np.argsort(d, axis=1)[:, :k]
            nbr[s:s + 4096] = part
            dist[s:s + 4096] = np.take_along_axis(d, part, axis=1)
    w = 1.0 / (dist + 1e-8)
    w = w / w.sum(axis=1, keepdims=True)
    result[unknown] = (coarse_points[nbr] * w[..., None]).sum(axis=1)
    return result


class PointCloudPreprocessor:
    """Hierarchical preprocessor: resample to ``total_points``, normalise,
    voxel-downsample to ``global_points``, write one ``.npz`` per pair."""

    def __init__(self, total_points: int = 120000, global_points: int = 30000,
                 seed: Optional[int] = None):
        self.total_points = total_points
        self.global_points = global_points
        self.rng = np.random.default_rng(seed)

    # the reference's method names for the module's functions
    def normalize_point_cloud(self, points, target_range: float = 1.8):
        return normalize_point_cloud(points, target_range)

    def denormalize_point_cloud(self, points, norm_params):
        return denormalize_point_cloud(points, norm_params)

    def consistent_downsample(self, points, target_size):
        """``voxel_grid_downsample`` with the preprocessor's generator."""
        return voxel_grid_downsample(points, target_size, self.rng)

    def consistent_upsample(self, coarse, original, indices):
        return consistent_upsample(coarse, original, indices)

    def _resample_to_total(self, points: np.ndarray) -> np.ndarray:
        """Force exactly total_points: voxel-down when larger, random repeat-up
        when smaller (reference: data/preprocessing.py:144-159)."""
        n = len(points)
        if n == self.total_points:
            return np.asarray(points, np.float32)
        if n > self.total_points:
            pts, _ = voxel_grid_downsample(points, self.total_points, self.rng)
            return pts
        idx = self.rng.choice(n, self.total_points, replace=True)
        return np.asarray(points, np.float32)[idx]

    def create_hierarchical_data(self, points: np.ndarray) -> Dict:
        """normalize -> voxel downsample, keeping indices
        (reference: data/preprocessing.py:129-136)."""
        pts_norm, norm_params = normalize_point_cloud(points)
        global_pts, global_idx = voxel_grid_downsample(
            pts_norm, self.global_points, self.rng)
        return {"full_points": pts_norm, "global_points": global_pts,
                "global_indices": global_idx, "norm_params": norm_params}

    def save_hierarchical_data(self, sim_points: np.ndarray,
                               real_points: np.ndarray, output_dir: str,
                               file_id: str) -> str:
        os.makedirs(output_dir, exist_ok=True)
        sim_points = self._resample_to_total(sim_points)
        real_points = self._resample_to_total(real_points)
        sim = self.create_hierarchical_data(sim_points)
        real = self.create_hierarchical_data(real_points)
        path = os.path.join(output_dir, f"{file_id}_hierarchical.npz")
        np.savez_compressed(
            path,
            sim_full=sim["full_points"], sim_global=sim["global_points"],
            sim_global_indices=sim["global_indices"],
            sim_norm_center=sim["norm_params"]["center"],
            sim_norm_scale=np.float32(sim["norm_params"]["scale"]),
            real_full=real["full_points"], real_global=real["global_points"],
            real_global_indices=real["global_indices"],
            real_norm_center=real["norm_params"]["center"],
            real_norm_scale=np.float32(real["norm_params"]["scale"]),
            total_points=np.int64(self.total_points),
            global_points=np.int64(self.global_points),
        )
        return path
