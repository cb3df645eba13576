from .augmentation import augment_points
from .dataset import (Batcher, HierarchicalPointCloudDataset, collate,
                      create_dataloaders)
from .preprocessing import (PointCloudPreprocessor, consistent_upsample,
                            denormalize_point_cloud, normalize_point_cloud,
                            voxel_grid_downsample)

__all__ = [
    "augment_points", "Batcher", "HierarchicalPointCloudDataset", "collate",
    "create_dataloaders", "PointCloudPreprocessor", "consistent_upsample",
    "denormalize_point_cloud", "normalize_point_cloud",
    "voxel_grid_downsample",
]
