"""Hand-written CUDA kernels (``csrc/``), each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors; nothing here imports a compiler or builds on
import."""

from ._common import LAUNCH_COUNTS, build_all, reset_launch_counts
from .ball_query import ball_query_cuda, ball_query_kernel, ball_query_plain
from .denoiser import (denoiser_block, denoiser_block_cuda,
                       denoiser_block_plain, takes_kernel)
from .fps import farthest_point_sample_kernel, fps_cuda, fps_plain
from .grid import (grid_interp, grid_interp_cuda, grid_interp_plain,
                   grid_topk, grid_topk_cuda, grid_topk_plain)
from .knn import knn_topk, knn_topk_cuda, knn_topk_plain
from .knn_packed import (knn_f32packed, knn_f32packed_keys,
                         knn_f32packed_keys_cuda, knn_f32packed_keys_plain,
                         knn_intpacked, knn_intpacked_keys,
                         knn_intpacked_keys_cuda, knn_intpacked_keys_plain)
from .knn_pruned import (knn_pruned_pass, knn_pruned_pass_cuda,
                         knn_pruned_pass_plain)
from .rowmin import rowmin_cuda, rowmin_kernel, rowmin_plain

__all__ = [
    "LAUNCH_COUNTS", "build_all", "reset_launch_counts",
    "ball_query_cuda", "ball_query_kernel", "ball_query_plain",
    "denoiser_block", "denoiser_block_cuda", "denoiser_block_plain",
    "takes_kernel",
    "farthest_point_sample_kernel", "fps_cuda", "fps_plain",
    "grid_interp", "grid_interp_cuda", "grid_interp_plain",
    "grid_topk", "grid_topk_cuda", "grid_topk_plain",
    "knn_topk", "knn_topk_cuda", "knn_topk_plain",
    "knn_f32packed", "knn_f32packed_keys", "knn_f32packed_keys_cuda",
    "knn_f32packed_keys_plain", "knn_intpacked", "knn_intpacked_keys",
    "knn_intpacked_keys_cuda", "knn_intpacked_keys_plain",
    "knn_pruned_pass", "knn_pruned_pass_cuda", "knn_pruned_pass_plain",
    "rowmin_cuda", "rowmin_kernel", "rowmin_plain",
]
