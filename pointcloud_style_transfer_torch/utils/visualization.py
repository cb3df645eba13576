"""Point-cloud visualization (matplotlib) + PLY export: the port's own copy
of ``pointcloud_style_transfer_tpu/utils/visualization.py`` (numpy only, no
torch). A 3-panel original / transferred / reference scatter, subsampled for
plotting, and an ASCII PLY writer. matplotlib is imported lazily (the Agg
backend) and open3d is optional: without them the functions return False.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _subsample(points: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    if len(points) <= n:
        return points
    idx = np.random.default_rng(seed).choice(len(points), n, replace=False)
    return points[idx]


def plot_style_transfer_result(original: np.ndarray, transferred: np.ndarray,
                               reference: np.ndarray,
                               title: str = "Style Transfer Result",
                               save_path: Optional[str] = None,
                               sample_size: int = 8000) -> bool:
    """3-panel comparison plot. Returns False if matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False

    fig = plt.figure(figsize=(18, 6))
    panels = [(original, "Original (Simulation)", "viridis"),
              (transferred, "Transferred", "plasma"),
              (reference, "Reference (Real)", "coolwarm")]
    for i, (pts, name, cmap) in enumerate(panels, 1):
        ax = fig.add_subplot(1, 3, i, projection="3d")
        p = _subsample(np.asarray(pts), sample_size)
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=p[:, 2], cmap=cmap, s=0.5)
        ax.set_title(name)
        ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
        ax.view_init(elev=20, azim=120)
    plt.suptitle(title, fontsize=16)
    plt.tight_layout(rect=[0, 0, 1, 0.96])
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        plt.savefig(save_path, dpi=200, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return True


def save_as_ply(points: np.ndarray, path: str) -> None:
    """Minimal dependency-free ASCII PLY writer."""
    points = np.asarray(points, dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        np.savetxt(f, points, fmt="%.6f")


def visualize_interactive(point_clouds, labels, colors=None) -> bool:
    """Interactive open3d window with one geometry per cloud. open3d is an
    optional dependency: returns False (after printing how to get it) when
    unavailable, so every caller degrades to the matplotlib/PLY path instead
    of crashing. On a headless GPU machine, PLY export and a local open3d
    are the intended workflow."""
    try:
        import open3d as o3d  # optional dependency
    except ImportError:
        print("open3d not available — install open3d locally for the "
              "interactive viewer, or use the PLY export instead")
        return False

    default = [0.5, 0.5, 0.5]
    vis = o3d.visualization.Visualizer()
    vis.create_window()
    for i, (points, _label) in enumerate(zip(point_clouds, labels)):
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(
            np.asarray(points, dtype=np.float64))
        pcd.paint_uniform_color(colors[i] if colors and i < len(colors)
                                else default)
        vis.add_geometry(pcd)
    vis.run()
    vis.destroy_window()
    return True


class PointCloudVisualizer:
    """Class facade over the functions above."""

    plot_style_transfer_result = staticmethod(plot_style_transfer_result)
    save_as_ply = staticmethod(save_as_ply)
    visualize_interactive = staticmethod(visualize_interactive)

    @staticmethod
    def visualize_comparison(original, reconstructed, reference,
                             title="Comparison", save_path=None):
        return plot_style_transfer_result(original, reconstructed, reference,
                                          title=title, save_path=save_path)
