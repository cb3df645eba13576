from .preprocessing import denormalize_point_cloud, normalize_point_cloud

__all__ = ["denormalize_point_cloud", "normalize_point_cloud"]
