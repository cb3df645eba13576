"""PyTorch + CUDA port of ``pointcloud_style_transfer_tpu`` for NVIDIA Hopper.

The same system — CFG-guided DDIM style transfer of LiDAR point clouds with a
PointNet++ style encoder — with the TPU's Pallas kernels rewritten by hand in
CUDA C++ (``csrc/``), each beside a plain PyTorch version that runs on the
CPU. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .config import Config

__all__ = ["Config", "__version__"]
