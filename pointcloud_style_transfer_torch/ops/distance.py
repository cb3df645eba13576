"""Point-distance primitives (counterpart of
``pointcloud_style_transfer_tpu/ops/distance.py``): the matmul-expansion
``square_distance``, the row minimum ``min_sq_dist`` with its custom gradient
(``MinSqDist``), the squared training Chamfer and the unsquared evaluation
Chamfer, and ``knn``.

The row minimum and ``knn`` dispatch between the CUDA kernels and their
plain versions. The plain versions compute distances in the squared-difference
form that the kernels (and the TPU's kernels) use, not the matmul expansion of
the JAX package's ``knn_jnp``/``min_sq_dist_jnp``: they are the kernels'
oracles, so they must select the same neighbours at near-ties.
"""

from __future__ import annotations

from typing import Optional

import torch

from .grid_knn import grid_knn
from .kernels import (knn_f32packed, knn_intpacked, knn_topk, knn_topk_plain,
                      rowmin_kernel, rowmin_plain)
from .kernels.knn_packed import MAX_REFS, padded_refs
from .pruned_knn import knn_pruned


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[..., N, C] x [..., M, C] -> [..., N, M] squared distances through the
    matmul expansion |s|^2 - 2 s.d + |d|^2, in float32 (may be slightly
    negative from rounding; callers clamp)."""
    src = src.float()
    dst = dst.float()
    d = -2.0 * torch.einsum("...nc,...mc->...nm", src, dst)
    d = d + torch.sum(src ** 2, dim=-1)[..., :, None]
    return d + torch.sum(dst ** 2, dim=-1)[..., None, :]


class MinSqDist(torch.autograd.Function):
    """The custom VJP of ``pallas_min_sq_dist``.

    Forward: without a gradient to compute, the row-min kernel, as the JAX
    primal runs it; with one, the k=1 kNN kernel, whose argmin (ties to the
    lowest index) is saved, as ``_min_sq_dist_fwd`` does. Backward
    (``_min_sq_dist_bwd``): dq = 2 (q - r[argmin]) g, and -dq scatter-added
    into the refs. The gather and the scatter stay ``torch.gather`` /
    ``index_add_``, as JAX computes them outside any Pallas kernel.

    ``selections`` (a dict, or None) pins the argmin the backward follows:
    the one under ``key`` is replayed when the dict holds it, else the
    kernel's is recorded there, with the points it was chosen on under
    ``key.query`` and ``key.ref``. A step on the card can so follow the
    CPU's choices at near-ties; the forward values stay the kernel's."""

    @staticmethod
    def forward(ctx, query: torch.Tensor, ref: torch.Tensor,
                grad_enabled: bool, selections: Optional[dict] = None,
                key: str = "argmin") -> torch.Tensor:
        q = query.float().contiguous()
        r = ref.float().contiguous()
        if not (grad_enabled and any(ctx.needs_input_grad[:2])):
            return rowmin_kernel(q, r)
        d, idx = knn_topk(q, r, 1)
        idx = idx[..., 0].long()
        if selections is not None and key in selections:
            idx = selections[key].to(idx.device)
        elif selections is not None:
            selections.update({key: idx, f"{key}.query": q.detach(),
                               f"{key}.ref": r.detach()})
        ctx.save_for_backward(q, r, idx)
        ctx.dtypes = (query.dtype, ref.dtype)
        return d[..., 0].clamp_min(0.0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, r, idx = ctx.saved_tensors
        B, M, _ = r.shape
        sel = torch.gather(r, 1, idx[..., None].expand(-1, -1, 3))
        dq = 2.0 * (q - sel) * g[..., None]
        flat = (idx + torch.arange(B, device=idx.device)[:, None] * M)
        dr = torch.zeros_like(r).view(B * M, 3).index_add_(
            0, flat.reshape(-1), -dq.reshape(-1, 3)).view(B, M, 3)
        return (dq.to(ctx.dtypes[0]), dr.to(ctx.dtypes[1]), None, None,
                None)


def min_sq_dist(query: torch.Tensor, ref: torch.Tensor,
                backend: str = "pallas", selections: Optional[dict] = None,
                key: str = "argmin") -> torch.Tensor:
    """Per-query min squared distance: query [B, N, 3], ref [B, M, 3] ->
    [B, N] float32, >= 0. ``backend="pallas"`` is ``MinSqDist`` (the kernels
    on CUDA tensors, their plain versions on CPU tensors; ``selections`` and
    ``key`` pin its argmin under grad); ``"jnp"`` the plain row minimum
    everywhere, differentiated by autograd (``Config.use_pallas=False``)."""
    if backend == "pallas":
        return MinSqDist.apply(query, ref, torch.is_grad_enabled(),
                               selections, key)
    if backend == "jnp":
        return rowmin_plain(query, ref)
    raise ValueError(f"unknown min_sq_dist backend: {backend!r}")


def chamfer_distance(pred: torch.Tensor, target: torch.Tensor,
                     backend: str = "pallas",
                     selections: Optional[dict] = None) -> torch.Tensor:
    """[B] bidirectional squared-L2 Chamfer (the training loss's):
    mean_n min_m |p_n - t_m|^2 + mean_m min_n |t_m - p_n|^2. ``selections``
    pins the two argmins (``min_sq_dist``) under the keys ``chamfer_pt`` and
    ``chamfer_tp``."""
    d_pt = min_sq_dist(pred, target, backend, selections, "chamfer_pt")
    d_tp = min_sq_dist(target, pred, backend, selections, "chamfer_tp")
    return d_pt.mean(dim=1) + d_tp.mean(dim=1)


def chamfer_distance_l2(pred: torch.Tensor, target: torch.Tensor,
                        backend: str = "pallas") -> torch.Tensor:
    """[B] evaluation Chamfer: *unsquared* L2, averaged over both directions
    and divided by 2."""
    d_pt = torch.sqrt(min_sq_dist(pred, target, backend))
    d_tp = torch.sqrt(min_sq_dist(target, pred, backend))
    return (d_pt.mean(dim=1) + d_tp.mean(dim=1)) / 2.0


def brute_knn(query: torch.Tensor, ref: torch.Tensor, k: int,
              exact: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The brute-force kNN with the JAX package's ``pallas_knn(query, ref, k,
    exact=...)`` switch: the exact kernel by default; with ``exact=False`` and
    at most 2^15 refs the int-packed kernel (``kernels.knn_packed``), whose
    selection can differ from the exact one between neighbours within about
    2^-7 relative distance and whose distances are recomputed exactly."""
    query = query.float().contiguous()
    ref = ref.float().contiguous()
    if not exact and ref.shape[1] <= MAX_REFS:
        return knn_intpacked(query, ref, k)
    return knn_topk(query, ref, k)


def knn_f32packed_or_exact(query: torch.Tensor, ref: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``pallas_knn_f32packed``: the f32-packed kernel (near-ties within
    about 2^-8 relative distance may be chosen differently; distances
    recomputed exactly), or the exact kernel when the refs, padded to the
    TPU wrapper's 4,096-ref tile, exceed the key's 2^15 index budget."""
    if padded_refs(ref.shape[1], 4096) > MAX_REFS:
        return knn_topk(query, ref, k)
    return knn_f32packed(query, ref, k)


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        backend: str = "pallas") -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs per query: query [B, N, 3], ref [B, M, 3] ->
    (sq_dists [B, N, k] float32, indices [B, N, k] int32), ascending, ties
    to the lowest ref index unless the backend says otherwise.

    ``backend="pallas"`` runs the brute-force kernel on CUDA tensors (its
    plain version on CPU tensors); ``"grid"`` the kd-grid (``grid_knn``:
    the slot-run kernel, the brute-force kernel for the rows it cannot
    prove exact); ``"pallas_f32packed"`` the f32-packed brute-force kernel
    (``knn_f32packed_or_exact``); ``"pallas_pruned"`` the Morton-pruned exact
    kNN (``pruned_knn.knn_pruned``; ties to the window's refs, then the
    lowest Morton-sorted position); ``"jnp"`` the brute plain version
    everywhere (``Config.use_pallas=False``)."""
    query = query.float().contiguous()
    ref = ref.float().contiguous()
    if backend == "pallas":
        return knn_topk(query, ref, k)
    if backend == "grid":
        return grid_knn(query, ref, k)
    if backend == "pallas_f32packed":
        return knn_f32packed_or_exact(query, ref, k)
    if backend == "pallas_pruned":
        return knn_pruned(query, ref, k)
    if backend == "jnp":
        return knn_topk_plain(query, ref, k)
    raise ValueError(f"unknown knn backend: {backend!r}")
