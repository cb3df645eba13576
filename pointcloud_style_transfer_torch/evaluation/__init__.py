"""Evaluation metrics of the port."""

from .metrics import (PointCloudMetrics, chamfer_distance, coverage_score,
                      earth_mover_distance, earth_mover_distance_greedy,
                      fidelity_score, hausdorff_distance, precision_recall_f1,
                      uniformity_score)

__all__ = [
    "PointCloudMetrics", "chamfer_distance", "coverage_score",
    "earth_mover_distance", "earth_mover_distance_greedy", "fidelity_score",
    "hausdorff_distance", "precision_recall_f1", "uniformity_score",
]
