"""Packed-key brute-force kNN: CUDA kernels + plain PyTorch versions.

Replaces two TPU kernels of ``pointcloud_style_transfer_tpu/ops/pallas/
distance_topk.py``, both in ``csrc/knn_packed.cu``:

* ``_topk_f32packed_kernel`` (wrapper ``_knn_f32packed_single``): the
  selection key is ``((bits(d) + 0x00800000) & ~0x7FFF) | index``, a float32
  on the TPU, whose low 15 mantissa bits carry the ref index;
* ``_topk_packed_kernel`` (wrapper ``_knn_packed_single``): an int32 key
  ``((bits(d) >>> 16) << idx_bits) | index``.

A key orders by the coarsened distance first (8 and 7 mantissa bits are
left), then by the index, so the selection can differ from the exact
kernel's only between neighbours within about 2^-8 (f32-packed) or 2^-7
(int-packed) relative distance. The wrappers then decode the index, recompute
the exact distance of each selected ref and sort the k results ascending
(stable), as the TPU wrappers do outside their kernels. Both are
compute-bound on the card like the exact kernel (``knn.py``): 8 float ops a
pair that the bit-identical contract keeps out of FMAs. Both take the
exact kernel's design, one scan in the source: one thread a query, its k
keys in registers, ref tiles through shared memory, the ref axis split
across a thread-block cluster of S blocks (``knn_topk_plan``'s S, or
``plan``) whose rank 0 merges the ranks' keys, and an eight-ref filter on
the distances' bits against a bound derived from the k-th key, so that keys
are built only for distances that can enter. Above ``MAX_K`` the keys
leave the registers: a kernel of the same source keeps each query's sorted
list in the output itself and takes no cluster (S = 1).

The TPU wrappers pad the refs to a multiple of their ref tile ``tr`` with
points at 1e15; the padded count ``m_total`` bounds the index budget (at most
2^15) and, for the int-packed key, sets ``idx_bits``. The kernels need no
padding but compute those points, so that k > M gives the TPU's answer: an
f32-packed slot that no ref fills keeps the start key 1e30, whose low 15 bits
decode to 29,386, clipped to M - 1; an int-packed slot takes the padding refs
M, M + 1, ..., clipped to M - 1.

NaN: a NaN distance (a NaN coordinate in the query or the ref) is never
selected, nor is an f32-packed distance that is infinite or >= 2^127; a query
with a NaN coordinate keeps the start keys in every slot and decodes as k > M
does, with NaN distances. This departs from the JAX kernels on purpose. The
f32-packed one takes its tile minimum over float keys, so a NaN key stops
that tile's insertions for the query (a result that depends on the tiling).
The int-packed one compares integers: a positive NaN's key, (0x7FC0 <<
idx_bits) | index, lies below the start value 2^30 for idx_bits <= 15 and
above every finite distance's, so JAX does insert it when fewer than k other
refs (padding included) are left, while a NaN with the sign bit set gives a
key above 2^30 that it never takes: the outcome follows the platform's NaN
bit pattern. The port's answer does not: kernel and plain version never take
a NaN, whatever its bits.

The f32-packed kernel takes the count on the device as ``knn_topk`` does
(``knn.py``): ``row_ids`` [B, n] int32 makes output row j of cloud b the
query row ``row_ids[b, j]`` (clipped to the cloud's rows), ``count`` [B]
int32 computes only the first ``count[b]`` output rows of cloud b, whose
query blocks at or past it exit without scanning; the rows past it hold the
start keys. The kd-grid's inexact fallback launches it so, over a buffer of
static size.
"""

from __future__ import annotations

import torch

from ._common import check_points, launch, pairwise_sq_dist
from .knn import CLUSTER_SIZES, MAX_K, _check_rows, _gather_rows, knn_topk_plan

MAX_REFS = 1 << 15  # the index budget of both keys
_FAR = 1e15  # the padding refs' coordinate
_START_F32 = 0x7149F2CA  # bits of float32 1e30, the f32-packed start key
_START_INT = 1 << 30  # the int-packed start key
_CHUNK_ELEMS = 1 << 23  # plain versions: distance-matrix elements per chunk


def padded_refs(m: int, tr: int) -> int:
    """M padded to a multiple of the TPU wrapper's ref tile."""
    return -(-m // tr) * tr


def packed_idx_bits(m_total: int) -> int:
    """Index bits of the int-packed key for ``m_total`` padded refs."""
    return max(1, m_total - 1).bit_length()


def _check_budget(m_total: int, what: str) -> None:
    if m_total > MAX_REFS:
        raise ValueError(f"{what} kNN supports at most 2^15 refs, got "
                         f"{m_total}")


def _keys_plain(query: torch.Tensor, ref: torch.Tensor, k: int, m_total: int,
                idx_bits: int | None, row_ids: torch.Tensor | None = None,
                count: torch.Tensor | None = None) -> torch.Tensor:
    """The k smallest keys per query, ascending, int32 [B, N, k];
    ``idx_bits=None`` is the f32-packed key. ``row_ids`` and ``count`` as
    the f32-packed kernel takes them (module docstring); the largest count
    is read on the host, a sync on the card, where this is the oracle."""
    query = query.float()
    ref = ref.float()
    if row_ids is not None:
        query = _gather_rows(query, row_ids)
    B, N, _ = query.shape
    M = ref.shape[1]
    f32 = idx_bits is None
    start = _START_F32 if f32 else _START_INT
    n_pad = min(k, m_total - M)
    pad = ref.new_full((B, n_pad, 3), _FAR)
    ref_p = torch.cat([ref, pad], dim=1)
    cols = torch.arange(M + n_pad, dtype=torch.int64, device=query.device)
    out = torch.full((B, N, k), start, dtype=torch.int32, device=query.device)
    n_rows = N
    if count is not None:
        count = count.to(query.device).long().clamp(0, N)
        n_rows = int(count.max()) if B else 0
    chunk = max(1, _CHUNK_ELEMS // max(M + n_pad, 1))
    for b in range(B):
        for s in range(0, n_rows, chunk):
            d = pairwise_sq_dist(query[b, s:s + chunk], ref_p[b])
            bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            if f32:
                # unsigned order; keys at or above the start are never taken
                keys = (((bits + 0x00800000) & 0xFFFFFFFF) & ~0x7FFF) | cols
            else:
                keys = ((bits >> 16) << idx_bits) | cols
            # a NaN, whatever its sign bit (a set one would wrap the
            # f32-packed key below every distance), is never taken
            keys = torch.where(torch.isnan(d), start, keys)
            keys = torch.cat([keys.clamp(max=start),
                              keys.new_full((keys.shape[0], k), start)], dim=1)
            top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
            out[b, s:s + chunk] = top.to(torch.int32)
    if count is not None:  # rows past the count: the start keys
        skipped = torch.arange(N, device=query.device)[None, :] >= count[:, None]
        out.masked_fill_(skipped[..., None], start)
    return out


def knn_f32packed_keys_plain(query: torch.Tensor, ref: torch.Tensor, k: int,
                             m_total: int, row_ids: torch.Tensor | None = None,
                             count: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The f32-packed kernel's function in plain PyTorch: float32 keys
    [B, N, k], ascending (``row_ids``, ``count`` as the kernel takes
    them)."""
    _check_budget(m_total, "f32-packed")
    return _keys_plain(query, ref, k, m_total, None, row_ids, count
                       ).view(torch.float32)


def knn_intpacked_keys_plain(query: torch.Tensor, ref: torch.Tensor, k: int,
                             m_total: int) -> torch.Tensor:
    """The int-packed kernel's function in plain PyTorch: int32 keys
    [B, N, k], ascending."""
    _check_budget(m_total, "packed")
    return _keys_plain(query, ref, k, m_total, packed_idx_bits(m_total))


def _check_launch_args(query, ref, k, m_total, what) -> None:
    check_points(query, "query")
    check_points(ref, "ref")
    if ref.shape[0] != query.shape[0] or ref.device != query.device:
        raise ValueError("query and ref must share batch size and device")
    if k < 1:
        raise ValueError(f"the kNN kernels take k >= 1, got {k}")
    if ref.shape[1] == 0:
        raise ValueError("kNN needs at least one ref point")
    if m_total < ref.shape[1]:
        raise ValueError("m_total must be at least the ref count")
    _check_budget(m_total, what)


def _cluster_size(B: int, N: int, M: int, k: int, plan: int | None,
                  what: str) -> int:
    """``plan`` or ``knn_topk_plan``'s S; above ``MAX_K`` the global-list
    kernel, which takes no cluster (S = 1)."""
    if k > MAX_K:
        S = 1 if plan is None else plan
        if S != 1:
            raise ValueError(f"k = {k} > {MAX_K} takes no cluster, got S={S}")
    else:
        S = knn_topk_plan(B, N, M) if plan is None else plan
    if S not in CLUSTER_SIZES:
        raise ValueError(f"bad {what} kNN cluster size {S}")
    return S


def knn_f32packed_keys_cuda(query: torch.Tensor, ref: torch.Tensor, k: int,
                            m_total: int, plan: int | None = None,
                            row_ids: torch.Tensor | None = None,
                            count: torch.Tensor | None = None,
                            plan_rows: int | None = None) -> torch.Tensor:
    """Launch ``pcst_knn_f32packed`` on the current stream, with
    ``knn_topk_plan``'s cluster size unless ``plan`` (S) is given: the
    kernels share their scan's shape, and S = 2 at the sampler's 90,000
    rows, 8 at the grid's patches. ``row_ids`` [B, n] and ``count`` [B]
    (int32, on the card) as the module docstring says; the plan is made for
    ``plan_rows`` rows a cloud when given, else for the launch's rows."""
    _check_launch_args(query, ref, k, m_total, "f32-packed")
    B, Nsrc, _ = query.shape
    M = ref.shape[1]
    _check_rows(row_ids, count, B, query.device)
    N = Nsrc if row_ids is None else row_ids.shape[1]
    if Nsrc == 0 and N:
        raise ValueError("row_ids need at least one query row")
    S = _cluster_size(B, N if plan_rows is None else plan_rows, M, k, plan,
                      "f32-packed")
    keys = torch.empty((B, N, k), dtype=torch.float32, device=query.device)
    if B * N:
        launch("knn_f32packed", query.device, query.data_ptr(),
               ref.data_ptr(), keys.data_ptr(),
               None if row_ids is None else row_ids.data_ptr(),
               None if count is None else count.data_ptr(), B, N,
               max(Nsrc, 1), M, m_total, k, S)
    return keys


def knn_intpacked_keys_cuda(query: torch.Tensor, ref: torch.Tensor, k: int,
                            m_total: int, plan: int | None = None
                            ) -> torch.Tensor:
    """Launch ``pcst_knn_packed`` on the current stream; the cluster size
    as ``knn_f32packed_keys_cuda``'s."""
    _check_launch_args(query, ref, k, m_total, "packed")
    B, N, _ = query.shape
    M = ref.shape[1]
    S = _cluster_size(B, N, M, k, plan, "packed")
    keys = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
    if B * N:
        launch("knn_packed", query.device, query.data_ptr(), ref.data_ptr(),
               keys.data_ptr(), B, N, M, m_total, packed_idx_bits(m_total),
               k, S)
    return keys


def knn_f32packed_keys(query: torch.Tensor, ref: torch.Tensor, k: int,
                       m_total: int, row_ids: torch.Tensor | None = None,
                       count: torch.Tensor | None = None,
                       plan_rows: int | None = None) -> torch.Tensor:
    """The k smallest f32-packed keys per query: the kernel for CUDA
    tensors, the plain version for CPU tensors (``row_ids``, ``count``,
    ``plan_rows`` as ``knn_f32packed_keys_cuda`` takes them)."""
    if query.device.type == "cpu":
        return knn_f32packed_keys_plain(query, ref, k, m_total, row_ids,
                                        count)
    return knn_f32packed_keys_cuda(query, ref, k, m_total, row_ids=row_ids,
                                   count=count, plan_rows=plan_rows)


def knn_intpacked_keys(query: torch.Tensor, ref: torch.Tensor, k: int,
                       m_total: int) -> torch.Tensor:
    """The k smallest int-packed keys per query: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if query.device.type == "cpu":
        return knn_intpacked_keys_plain(query, ref, k, m_total)
    return knn_intpacked_keys_cuda(query, ref, k, m_total)


def selected_sq_dist(query: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Exact squared distances [B, N, k] from each query [B, N, 3] to its
    selected refs [B, N, k, 3], in the kernels' form (dx*dx + dy*dy) + dz*dz."""
    diff = query[:, :, None, :] - sel
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def decode_keys(query: torch.Tensor, ref: torch.Tensor, ikeys: torch.Tensor,
                idx_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """What the TPU wrappers do with the kernel's keys: the index is the
    key's low ``idx_bits`` clipped to [0, M-1]; the distance of each selected
    ref is recomputed exactly; the k results are sorted ascending by it
    (stable). Returns (sq_dists [B, N, k] float32, indices [B, N, k] int32)."""
    M = ref.shape[1]
    idx = (ikeys & ((1 << idx_bits) - 1)).clamp(0, M - 1)
    B, N, k = idx.shape
    sel = torch.gather(ref, 1, idx.long().reshape(B, N * k, 1).expand(-1, -1, 3)
                       ).reshape(B, N, k, 3)
    d = selected_sq_dist(query, sel)
    d, order = torch.sort(d, dim=2, stable=True)
    return d, torch.gather(idx, 2, order)


def knn_f32packed(query: torch.Tensor, ref: torch.Tensor, k: int,
                  tr: int = 4096, row_ids: torch.Tensor | None = None,
                  count: torch.Tensor | None = None,
                  plan_rows: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32-packed kNN with exact recomputed distances (the batched
    ``_knn_f32packed_single``): query [B, N, 3], ref [B, M, 3] -> (sq_dists
    [B, N, k] float32, indices [B, N, k] int32), ascending. ``tr`` is the TPU
    wrapper's ref tile: it only sets the padded ref count. Raises beyond 2^15
    padded refs. With ``row_ids`` [B, n] and ``count`` [B] (module
    docstring) the rows are the gathered ones; those past a cloud's count
    decode the start keys and are the caller's to drop."""
    query = query.float().contiguous()
    ref = ref.float().contiguous()
    keys = knn_f32packed_keys(query, ref, k, padded_refs(ref.shape[1], tr),
                              row_ids, count, plan_rows)
    if row_ids is not None:
        query = _gather_rows(query, row_ids)
    return decode_keys(query, ref, keys.view(torch.int32), 15)


def knn_intpacked(query: torch.Tensor, ref: torch.Tensor, k: int,
                  tr: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Int-packed kNN with exact recomputed distances (the batched
    ``_knn_packed_single``); arguments and results as ``knn_f32packed``."""
    query = query.float().contiguous()
    ref = ref.float().contiguous()
    m_total = padded_refs(ref.shape[1], tr)
    keys = knn_intpacked_keys(query, ref, k, m_total)
    return decode_keys(query, ref, keys, packed_idx_bits(m_total))
