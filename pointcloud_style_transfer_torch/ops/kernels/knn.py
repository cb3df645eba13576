"""Exact brute-force k nearest neighbours: CUDA kernel + plain PyTorch version.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::
_topk_kernel`` (wrappers ``_knn_single``, ``pallas_knn``); kernel source
``csrc/knn_topk.cu``. It is bound by operations: 8 float ops per pair that
the bit-identical contract keeps out of FMAs, so its floor is the card's
FP32 issue rate. A few thousand queries (the kd-grid's patches) give too few
threads to fill the card with one thread per query, so ``knn_topk_plan``
splits the ref axis across a thread-block cluster of S blocks, whose rank 0
merges the ranks' lists through distributed shared memory in one launch.
Above ``MAX_K`` the lists no longer fit the registers: a second kernel of
the same source keeps each query's sorted list in the output itself (global
memory, [B, Nq, k]) and its k-th distance in a register, with the same scan
and no cluster. The JAX wrapper's query chunking exists only to dodge a TPU
VMEM limit and has no counterpart here.

Both versions return ascending squared distances [B, Nq, k] float32 and
indices [B, Nq, k] int32 with ties to the lowest ref index, for any
k >= 1; slots no ref fills (k > M) hold (1e30, 0); a NaN distance is never
taken; indices are clipped to [0, M-1].

The count on the device (the kd-grid's fallback ladder, which decides on
the device how many rows to recompute): ``row_ids`` [B, n] int32 makes
output row j of cloud b the query row ``row_ids[b, j]`` (clipped to the
cloud's rows), and ``count`` [B] int32 computes only the first
``count[b]`` output rows of cloud b; the others hold the start list
(1e30, 0). The kernel reads the count from device memory, and its query
blocks at or past it exit without scanning, so the launch's size stays
static while the work follows the data.
"""

from __future__ import annotations

import torch

from ._common import check_points, launch, pairwise_sq_dist

MAX_K = 16  # lists in registers for 1 <= k <= 16; above, in global memory
CLUSTER_SIZES = (1, 2, 4, 8)  # ranks per cluster (the portable sizes)
THREADS = 128        # queries per block, as in csrc/knn_topk.cu
_SMS = 132           # streaming multiprocessors of an H100
_MIN_SLICE = 1024    # refs a rank scans at least
_BIG = 1e30  # the running top-k's initial distance, as on the TPU
_NAN_KEY = 0x7F800000 << 32  # a NaN distance's key: +inf's bits, never taken
_CHUNK_ELEMS = 1 << 23  # plain version: distance-matrix elements per chunk


def _gather_rows(query: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
    """[B, Nsrc, 3] query rows at ``row_ids`` [B, n] (clipped as the kernel
    clips them) -> [B, n, 3]."""
    idx = row_ids.long().clamp(0, query.shape[1] - 1)
    return torch.gather(query, 1, idx[..., None].expand(*idx.shape, 3))


def knn_topk_plain(query: torch.Tensor, ref: torch.Tensor, k: int,
                   row_ids: torch.Tensor | None = None,
                   count: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, for CPU tensors and tests.

    Selection is exact on (distance, index): the float32 distance bits (a
    non-negative float orders like its bit pattern) and the index are packed
    into one int64 key, so ``topk`` over unique keys keeps the lowest index
    on equal distances. A NaN, whatever its sign bit, takes +inf's key, and
    an entry at or above 1e30 becomes the start entry (1e30, 0).
    ``row_ids`` and ``count`` as the kernel takes them (module docstring);
    the largest count is read on the host, which on the card is a sync: the
    plain version is the card's oracle, not its path."""
    query = query.float()
    ref = ref.float()
    if row_ids is not None:
        query = _gather_rows(query, row_ids)
    B, N, _ = query.shape
    M = ref.shape[1]
    kk = min(k, M)
    d_out = torch.full((B, N, k), _BIG, dtype=torch.float32, device=query.device)
    i_out = torch.zeros((B, N, k), dtype=torch.int32, device=query.device)
    n_rows = N
    if count is not None:
        count = count.to(query.device).long().clamp(0, N)
        n_rows = int(count.max()) if B else 0
    ids = torch.arange(M, dtype=torch.int64, device=query.device)
    chunk = max(1, _CHUNK_ELEMS // max(M, 1))
    for b in range(B):
        for s in range(0, n_rows, chunk):
            d = pairwise_sq_dist(query[b, s:s + chunk], ref[b])
            keys = (d.view(torch.int32).to(torch.int64) << 32) | ids
            keys = keys.masked_fill(torch.isnan(d), _NAN_KEY)
            top = torch.topk(keys, kk, dim=1, largest=False, sorted=True).values
            dd = (top >> 32).to(torch.int32).view(torch.float32)
            ii = (top & 0xFFFFFFFF).to(torch.int32)
            taken = dd < _BIG  # the kernel inserts only on strict '<'
            d_out[b, s:s + chunk, :kk] = torch.where(taken, dd, _BIG)
            i_out[b, s:s + chunk, :kk] = torch.where(taken, ii, 0)
    i_out.clamp_(0, max(M - 1, 0))
    if count is not None:  # rows past the count: the start list
        skipped = (torch.arange(N, device=query.device)[None, :]
                   >= count[:, None])[..., None]
        d_out.masked_fill_(skipped, _BIG)
        i_out.masked_fill_(skipped, 0)
    return d_out, i_out


def _last_round_full(blocks: int) -> float:
    """The share of the busiest SM's blocks that the average SM also runs:
    blocks / 132 over its ceiling."""
    rounds = blocks / _SMS
    return rounds / -(-blocks // _SMS)


def knn_topk_plan(B: int, nq: int, m: int) -> int:
    """The cluster size S for B clouds of nq queries x m refs, chosen from
    ``tools/sweep_kernel_plans.py`` on an H100 (PERF.md, PR 5): blocks of
    ``THREADS`` queries, then the smallest S whose clusters give two blocks
    per SM, each rank's slice at least ``_MIN_SLICE`` refs (S = 8 at the
    kd-grid's patches of 500-4,096 rows, 4 at 16,384, 2 at 32,768). S
    doubles once more where that evens out the SMs' last round of blocks:
    90,000 queries are 704 blocks, 5.33 per SM, so the busiest SMs run 6,
    while S = 2 gives 10.67 per SM against 11 and measured 7% faster. The
    plan takes no k: at 30,000 x 30,000 its S = 2 measured fastest at
    k = 9, within 3% at k = 16 and 7-13% behind S = 4 at k = 1 and 3."""
    blocks = B * -(-nq // THREADS)
    sizes = [s for s in CLUSTER_SIZES if s == 1 or m // s >= _MIN_SLICE]
    S = next((s for s in sizes if blocks * s >= 2 * _SMS), sizes[-1])
    if 2 * S in sizes and (_last_round_full(2 * S * blocks)
                           > _last_round_full(S * blocks) + 0.05):
        S *= 2
    return S


def _check_rows(row_ids, count, B: int, device: torch.device) -> None:
    for t, what in ((row_ids, "row_ids"), (count, "count")):
        if t is not None and (t.device != device or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous int32 tensor on "
                             f"{device}")
    if row_ids is not None and (row_ids.dim() != 2 or row_ids.shape[0] != B):
        raise ValueError(f"row_ids must be [{B}, n], got "
                         f"{tuple(row_ids.shape)}")
    if count is not None and count.shape != (B,):
        raise ValueError(f"count must be [{B}], got {tuple(count.shape)}")


def knn_topk_cuda(query: torch.Tensor, ref: torch.Tensor, k: int,
                  plan: int | None = None,
                  row_ids: torch.Tensor | None = None,
                  count: torch.Tensor | None = None,
                  plan_rows: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/knn_topk.cu`` on the current stream, with
    ``knn_topk_plan``'s cluster size unless ``plan`` (S) is given. Above
    ``MAX_K`` the global-list kernel runs, which takes no cluster (S = 1).
    ``row_ids`` [B, n] and ``count`` [B] (int32, on the card) as the module
    docstring says; the plan is made for ``plan_rows`` rows a cloud when
    given (the rows a count is expected to leave, which the host does not
    know), else for the launch's rows."""
    check_points(query, "query")
    check_points(ref, "ref")
    B, Nsrc, _ = query.shape
    M = ref.shape[1]
    if ref.shape[0] != B or ref.device != query.device:
        raise ValueError("query and ref must share batch size and device")
    _check_rows(row_ids, count, B, query.device)
    N = Nsrc if row_ids is None else row_ids.shape[1]
    if Nsrc == 0 and N:
        raise ValueError("row_ids need at least one query row")
    if k < 1:
        raise ValueError(f"the kNN kernel takes k >= 1, got {k}")
    if M == 0:
        raise ValueError("kNN needs at least one ref point")
    if k > MAX_K:
        S = 1 if plan is None else plan
        if S != 1:
            raise ValueError(f"k = {k} > {MAX_K} takes no cluster, got S={S}")
    else:
        S = (knn_topk_plan(B, N if plan_rows is None else plan_rows, M)
             if plan is None else plan)
    if S not in CLUSTER_SIZES:
        raise ValueError(f"bad kNN cluster size {S}")
    d = torch.empty((B, N, k), dtype=torch.float32, device=query.device)
    i = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
    if B * N:
        launch("knn_topk", query.device, query.data_ptr(), ref.data_ptr(),
               d.data_ptr(), i.data_ptr(),
               None if row_ids is None else row_ids.data_ptr(),
               None if count is None else count.data_ptr(), B, N, max(Nsrc, 1),
               M, k, S)
    return d, i


def knn_topk(query: torch.Tensor, ref: torch.Tensor, k: int,
             row_ids: torch.Tensor | None = None,
             count: torch.Tensor | None = None,
             plan_rows: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs per query: the kernel for CUDA tensors, the plain
    version for CPU tensors (``row_ids``, ``count``, ``plan_rows`` as
    ``knn_topk_cuda`` takes them)."""
    if query.device.type == "cpu":
        return knn_topk_plain(query, ref, k, row_ids, count)
    return knn_topk_cuda(query, ref, k, row_ids=row_ids, count=count,
                         plan_rows=plan_rows)
