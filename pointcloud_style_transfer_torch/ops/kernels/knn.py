"""Exact brute-force k nearest neighbours: CUDA kernel + plain PyTorch version.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::
_topk_kernel`` (wrappers ``_knn_single``, ``pallas_knn``); kernel source
``csrc/knn_topk.cu``. It is compute-bound on the card (2.7e9 pairs per
sampler step against ~1.5 MB of inputs): one thread per query keeps its
sorted top-k in registers while the block streams ref tiles through shared
memory. The JAX wrapper's query chunking exists only to dodge a TPU VMEM
limit and has no counterpart here.

Both versions return ascending squared distances [B, Nq, k] float32 and
indices [B, Nq, k] int32 with ties to the lowest ref index; slots no ref
fills (k > M) hold (1e30, 0); indices are clipped to [0, M-1].
"""

from __future__ import annotations

import torch

from ._common import check_points, launch, pairwise_sq_dist

MAX_K = 16  # the kernel is instantiated for 1 <= k <= 16
_BIG = 1e30  # the running top-k's initial distance, as on the TPU
_CHUNK_ELEMS = 1 << 23  # plain version: distance-matrix elements per chunk


def knn_topk_plain(query: torch.Tensor, ref: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, for CPU tensors and tests.

    Selection is exact on (distance, index): the float32 distance bits (a
    non-negative float orders like its bit pattern) and the index are packed
    into one int64 key, so ``topk`` over unique keys keeps the lowest index
    on equal distances."""
    query = query.float()
    ref = ref.float()
    B, N, _ = query.shape
    M = ref.shape[1]
    kk = min(k, M)
    d_out = torch.full((B, N, k), _BIG, dtype=torch.float32, device=query.device)
    i_out = torch.zeros((B, N, k), dtype=torch.int32, device=query.device)
    ids = torch.arange(M, dtype=torch.int64, device=query.device)
    chunk = max(1, _CHUNK_ELEMS // max(M, 1))
    for b in range(B):
        for s in range(0, N, chunk):
            d = pairwise_sq_dist(query[b, s:s + chunk], ref[b])
            keys = (d.view(torch.int32).to(torch.int64) << 32) | ids
            top = torch.topk(keys, kk, dim=1, largest=False, sorted=True).values
            dd = (top >> 32).to(torch.int32).view(torch.float32)
            ii = (top & 0xFFFFFFFF).to(torch.int32)
            taken = dd < _BIG  # the kernel inserts only on strict '<'
            d_out[b, s:s + chunk, :kk] = torch.where(taken, dd, _BIG)
            i_out[b, s:s + chunk, :kk] = torch.where(taken, ii, 0)
    return d_out, i_out.clamp_(0, max(M - 1, 0))


def knn_topk_cuda(query: torch.Tensor, ref: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/knn_topk.cu`` on the current stream."""
    check_points(query, "query")
    check_points(ref, "ref")
    B, N, _ = query.shape
    M = ref.shape[1]
    if ref.shape[0] != B or ref.device != query.device:
        raise ValueError("query and ref must share batch size and device")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kNN kernel takes 1 <= k <= {MAX_K}, got {k}")
    if M == 0:
        raise ValueError("kNN needs at least one ref point")
    d = torch.empty((B, N, k), dtype=torch.float32, device=query.device)
    i = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
    if B * N:
        launch("knn_topk", query.device, query.data_ptr(), ref.data_ptr(),
               d.data_ptr(), i.data_ptr(), B, N, M, k)
    return d, i


def knn_topk(query: torch.Tensor, ref: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs per query: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if query.device.type == "cpu":
        return knn_topk_plain(query, ref, k)
    return knn_topk_cuda(query, ref, k)
