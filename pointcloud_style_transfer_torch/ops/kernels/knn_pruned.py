"""One pass of the Morton-pruned exact kNN: CUDA kernel + plain PyTorch
version.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/pruned_knn.py::
_pruned_topk_kernel`` (``_run_pass``); kernel source ``csrc/knn_pruned.cu``.
``ops/pruned_knn.py`` drives it twice per cloud. A pass takes Morton-sorted
queries [nq * tq, 3] and refs [nr * tr, 3], both padded to whole tiles, a skip
matrix [nq, nr] (non-zero: that ref tile is pruned for that query tile) and a
running top-k (``d_init``, ``i_init``) [nq * tq, k], and returns the running
top-k after the unskipped tiles: ascending distances and sorted ref positions
(unclipped). A candidate enters only on strict '<' against the k-th entry,
ref tiles ascending and sorted positions ascending inside a tile, so on equal
distances an earlier pass's entry stays first, then the lowest sorted
position. It is compute-bound on the pairs the skip matrix leaves. The
kernel gives 128 queries of a query tile a thread-block cluster of S blocks
(``PCST_PRUNED_S``, a constant of the source) that share the row's unskipped
ref tiles by ordinal, and merges the ranks' lists in rank 0 in an order that
keeps those ties; the query tiles with the most unskipped tiles start first;
a warp of 32 queries lets a chunk of 1,024 refs go when none of them is
nearer the chunk's bounding box than its k-th distance (exact: the box
distance bounds every ref's from below in the same rounding); the scan
tries eight refs per insert test. Any k >= 1: above 16 a kernel of
the same source keeps each row's list in the output itself, with the same
order of arrival, and no cluster.

NaN: a NaN distance is never taken (the TPU kernel's tile minimum would
propagate it and drop that whole tile for the query; the port does not follow
that). A query with a NaN coordinate returns its initial state.
"""

from __future__ import annotations

import torch

from ._common import launch, pairwise_sq_dist

_BIG = 1e30  # an initial distance: nothing at or above it is ever taken
_KEY_MAX = torch.iinfo(torch.int64).max


def _check_pass_args(query, ref, skip, d_init, i_init, k, tq, tr) -> tuple:
    if query.dim() != 2 or query.shape[1] != 3 or query.shape[0] % tq:
        raise ValueError(f"query must be [nq * {tq}, 3], got "
                         f"{tuple(query.shape)}")
    if ref.dim() != 2 or ref.shape[1] != 3 or ref.shape[0] % tr:
        raise ValueError(f"ref must be [nr * {tr}, 3], got {tuple(ref.shape)}")
    nq, nr = query.shape[0] // tq, ref.shape[0] // tr
    if nq < 1 or nr < 1:
        raise ValueError("a pass needs at least one query and one ref tile")
    if tuple(skip.shape) != (nq, nr):
        raise ValueError(f"skip must be [{nq}, {nr}], got {tuple(skip.shape)}")
    for t, what in ((d_init, "d_init"), (i_init, "i_init")):
        if tuple(t.shape) != (query.shape[0], k):
            raise ValueError(f"{what} must be [{query.shape[0]}, {k}], got "
                             f"{tuple(t.shape)}")
    if k < 1:
        raise ValueError(f"the kNN kernels take k >= 1, got {k}")
    return nq, nr


def knn_pruned_pass_plain(query: torch.Tensor, ref: torch.Tensor,
                          skip: torch.Tensor, d_init: torch.Tensor,
                          i_init: torch.Tensor, k: int, tq: int, tr: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, query tile by query tile.

    The order of arrival decides ties, so every entry gets an int64 key of
    its float32 distance bits (a non-negative float orders like its bit
    pattern) and its arrival rank: the initial entries 0..k-1, then k + the
    sorted ref position; the k smallest keys are the pass's result."""
    nq, nr = _check_pass_args(query, ref, skip, d_init, i_init, k, tq, tr)
    query, ref = query.float(), ref.float()
    dev = query.device
    pos = torch.arange(ref.shape[0], dtype=torch.int64, device=dev) + k
    slot = torch.arange(k, dtype=torch.int64, device=dev)
    d_out = torch.empty_like(d_init, dtype=torch.float32)
    i_out = torch.empty_like(i_init, dtype=torch.int32)
    for qi in range(nq):
        rows = slice(qi * tq, (qi + 1) * tq)
        d = pairwise_sq_dist(query[rows], ref)
        keys = (d.view(torch.int32).to(torch.int64) << 32) | pos
        # only a distance below an initial 1e30 can ever be taken (never NaN)
        pruned = (skip[qi] != 0).repeat_interleave(tr)
        keys = torch.where(pruned[None, :] | ~(d < _BIG), _KEY_MAX, keys)
        d0 = d_init[rows].float()
        keys0 = (d0.view(torch.int32).to(torch.int64) << 32) | slot
        top = torch.topk(torch.cat([keys0, keys], dim=1), k, dim=1,
                         largest=False, sorted=True).values
        rank = top & 0xFFFFFFFF
        kept = rank < k
        i_kept = torch.gather(i_init[rows].long(), 1, rank.clamp(max=k - 1))
        d_out[rows] = (top >> 32).to(torch.int32).view(torch.float32)
        i_out[rows] = torch.where(kept, i_kept, rank - k).to(torch.int32)
    return d_out, i_out


def knn_pruned_pass_cuda(query: torch.Tensor, ref: torch.Tensor,
                         skip: torch.Tensor, d_init: torch.Tensor,
                         i_init: torch.Tensor, k: int, tq: int, tr: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/knn_pruned.cu`` on the current stream."""
    nq, nr = _check_pass_args(query, ref, skip, d_init, i_init, k, tq, tr)
    for t, what, dtype in ((query, "query", torch.float32),
                           (ref, "ref", torch.float32),
                           (skip, "skip", torch.int32),
                           (d_init, "d_init", torch.float32),
                           (i_init, "i_init", torch.int32)):
        if t.device.type != "cuda" or t.device != query.device:
            raise ValueError(f"{what} must be a CUDA tensor on the queries' "
                             f"device, got {t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous {dtype}")
    d_out = torch.empty_like(d_init)
    i_out = torch.empty_like(i_init)
    launch("knn_pruned", query.device, query.data_ptr(), ref.data_ptr(),
           skip.data_ptr(), d_init.data_ptr(), i_init.data_ptr(),
           d_out.data_ptr(), i_out.data_ptr(), nq, nr, tq, tr, k)
    return d_out, i_out


def knn_pruned_pass(query: torch.Tensor, ref: torch.Tensor,
                    skip: torch.Tensor, d_init: torch.Tensor,
                    i_init: torch.Tensor, k: int, tq: int, tr: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pruned pass: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if query.device.type == "cpu":
        return knn_pruned_pass_plain(query, ref, skip, d_init, i_init, k, tq,
                                     tr)
    return knn_pruned_pass_cuda(query, ref, skip, d_init, i_init, k, tq, tr)
