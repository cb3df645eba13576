"""Point-cloud primitives: plain PyTorch code plus the CUDA kernels in
``ops/kernels``."""

from . import grid_knn
from .distance import (MinSqDist, chamfer_distance, chamfer_distance_l2, knn,
                       min_sq_dist, square_distance)
from .sampling import (complement_indices, farthest_point_sample,
                       index_points, query_ball_point)
from .voxel import voxel_downsample, voxel_downsample_partition

__all__ = [
    "grid_knn", "knn", "MinSqDist", "min_sq_dist", "square_distance",
    "chamfer_distance", "chamfer_distance_l2", "index_points", "complement_indices", "farthest_point_sample",
    "query_ball_point", "voxel_downsample", "voxel_downsample_partition",
]
