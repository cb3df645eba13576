"""Row minimum of squared distance: CUDA kernel + plain PyTorch version.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::
_rowmin_kernel`` (wrappers ``_rowmin_single``, ``pallas_min_sq_dist``'s
primal); kernel source ``csrc/rowmin.cu``. It is bound by operations at the
card's FP32 issue rate: 8 float ops per pair that the bit-identical contract
keeps out of FMAs (1.44e10 pairs for the compare CLI's 120k x 120k call
against 2.9 MB of inputs). Each thread keeps Q queries' minima in registers
while the block streams ref tiles through shared memory, so one broadcast
shared load serves Q pairs, and the NaN-keeping minimum is one instruction
(PTX ``min.NaN.f32``). A thread-block cluster of S blocks splits the ref
axis, so that the Chamfer loss's 30,000 points fill the card, and its rank 0
merges the ranks' minima through distributed shared memory in the same
launch. S and Q are constants of the source (``PCST_ROWMIN_S`` = 8,
``PCST_ROWMIN_Q`` = 4), chosen with ``tools/sweep_kernel_plans.py``.

Both versions return [B, Nq] float32: min over refs of the squared distance
in the kernels' form (``_common.pairwise_sq_dist``), capped at the scan's
initial 1e30 and clamped at >= 0; a NaN distance makes its row NaN, as
``jnp.minimum``/``jnp.maximum`` propagate it on the TPU. The values are
identical between the two, not merely close: a minimum of non-NaN floats does
not depend on the order of the scan, nor on how it is split.
"""

from __future__ import annotations

import torch

from ._common import check_points, launch, pairwise_sq_dist

_BIG = 1e30  # the running minimum's initial value, as on the TPU
_CHUNK_ELEMS = 1 << 23  # plain version: distance-matrix elements per chunk


def rowmin_plain(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, for CPU tensors and tests.
    Differentiable (``amin`` shares the gradient among tied refs)."""
    query = query.float()
    ref = ref.float()
    B, N, _ = query.shape
    M = ref.shape[1]
    chunk = max(1, _CHUNK_ELEMS // max(M, 1))
    d = query.new_empty((B, N))
    for b in range(B):
        for s in range(0, N, chunk):
            d[b, s:s + chunk] = pairwise_sq_dist(query[b, s:s + chunk],
                                                 ref[b]).amin(1)
    # torch.minimum / clamp_min propagate NaN, as jnp.minimum / maximum do
    return torch.minimum(d, d.new_tensor(_BIG)).clamp_min(0.0)


def rowmin_cuda(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/rowmin.cu`` on the current stream."""
    check_points(query, "query")
    check_points(ref, "ref")
    B, N, _ = query.shape
    M = ref.shape[1]
    if ref.shape[0] != B or ref.device != query.device:
        raise ValueError("query and ref must share batch size and device")
    if M == 0:
        raise ValueError("the row minimum needs at least one ref point")
    out = torch.empty((B, N), dtype=torch.float32, device=query.device)
    if B * N:
        launch("rowmin", query.device, query.data_ptr(), ref.data_ptr(),
               out.data_ptr(), B, N, M)
    return out


def rowmin_kernel(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Min squared distance per query: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if query.device.type == "cpu":
        return rowmin_plain(query, ref)
    return rowmin_cuda(query, ref)
