"""k nearest neighbours, dispatched between the CUDA kernel and its plain
version (counterpart of ``pointcloud_style_transfer_tpu/ops/distance.py::knn``).

The plain version computes distances in the squared-difference form that the
kernel (and the TPU's ``_topk_kernel``) uses, not the matmul expansion of
the JAX package's ``knn_jnp``: it is the kernel's oracle, so it must select
the same neighbours at near-ties.
"""

from __future__ import annotations

import torch

from .grid_knn import grid_knn
from .kernels import knn_topk, knn_topk_plain

# Backends of the JAX package that this port does not have yet, with the
# ROADMAP item that ports each.
UNPORTED_KNN_BACKENDS = {
    "pallas_f32packed": "ROADMAP queue 2 item 7 (_topk_f32packed_kernel)",
    "pallas_pruned": "ROADMAP queue 2 item 9 (_pruned_topk_kernel)",
}


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        backend: str = "pallas") -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs per query: query [B, N, 3], ref [B, M, 3] ->
    (sq_dists [B, N, k] float32, indices [B, N, k] int32), ascending, ties
    to the lowest ref index.

    ``backend="pallas"`` runs the brute-force kernel on CUDA tensors (its
    plain version on CPU tensors); ``"grid"`` the kd-grid (``grid_knn``:
    the slot-run kernel, the brute-force kernel for the rows it cannot
    prove exact); ``"jnp"`` the brute plain version everywhere
    (``Config.use_pallas=False``)."""
    if backend in UNPORTED_KNN_BACKENDS:
        raise NotImplementedError(
            f"knn backend {backend!r} is not ported yet: "
            f"{UNPORTED_KNN_BACKENDS[backend]}")
    query = query.float().contiguous()
    ref = ref.float().contiguous()
    if backend == "pallas":
        return knn_topk(query, ref, k)
    if backend == "grid":
        return grid_knn(query, ref, k)
    if backend == "jnp":
        return knn_topk_plain(query, ref, k)
    raise ValueError(f"unknown knn backend: {backend!r}")
