"""Point-cloud primitives: plain PyTorch code plus the CUDA kernels in
``ops/kernels``."""

from . import grid_knn
from .distance import (MinSqDist, brute_knn, chamfer_distance,
                       chamfer_distance_l2, knn, knn_f32packed_or_exact,
                       min_sq_dist, square_distance)
from .interpolate import (apply_interpolation, knn_interpolate,
                          knn_interpolate_weights)
from .pruned_knn import knn_pruned
from .sampling import (complement_indices, farthest_point_sample,
                       index_points, query_ball_point)
from .voxel import (voxel_downsample, voxel_downsample_partition,
                    voxel_downsample_with_complement)

__all__ = [
    "grid_knn", "knn", "brute_knn", "knn_f32packed_or_exact", "knn_pruned",
    "MinSqDist", "min_sq_dist", "square_distance", "chamfer_distance",
    "chamfer_distance_l2", "knn_interpolate", "knn_interpolate_weights",
    "apply_interpolation", "index_points", "complement_indices",
    "farthest_point_sample",
    "query_ball_point", "voxel_downsample", "voxel_downsample_partition",
    "voxel_downsample_with_complement",
]
