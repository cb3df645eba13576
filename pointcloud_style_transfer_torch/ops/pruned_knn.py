"""Exact pruned kNN: Morton-ordered tiles + bound-based tile skipping
(counterpart of ``pointcloud_style_transfer_tpu/ops/pallas/pruned_knn.py``).

1. Queries and refs sort by a 30-bit Morton code over shared bounds, so a
   tile of consecutive points is spatially coherent.
2. Pass 1 runs the top-k against a window of ``window`` ref tiles around each
   query tile's proportional position: a sound upper bound on every query's
   k-th distance.
3. Ref tile j is skipped for query tile i in pass 2 when the squared distance
   between their bounding boxes exceeds the tile's worst k-th distance of
   pass 1 (or when pass 1 already covered it).
4. Pass 2 runs the same kernel (``ops/kernels/knn_pruned.py``,
   ``csrc/knn_pruned.cu``) over the tiles that are left, starting from pass
   1's running state.

The distances are the brute-force kernel's. Ties are not: on equal distances
the window's refs come first, then the lowest Morton-sorted position. All
the bookkeeping is plain PyTorch on the clouds' device, with no host
synchronisation; clouds of a batch run one after another.
"""

from __future__ import annotations

import torch

from .kernels import knn_pruned_pass

_BIG = 1e30
_FAR = 1e15  # the padding refs' coordinate


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(pts: torch.Tensor, lo: torch.Tensor,
                 inv_extent: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int32) for [N, 3] points given shared bounds."""
    q = ((pts - lo) * inv_extent * 1023.0).clamp(0, 1023).to(torch.int32)
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))


def _tile_bboxes(pts: torch.Tensor, tile: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, 3] mins and maxes of each tile of ``tile`` consecutive points."""
    r = pts.reshape(pts.shape[0] // tile, tile, 3)
    return r.amin(dim=1), r.amax(dim=1)


def _bbox_sq_dist(amin, amax, bmin, bmax) -> torch.Tensor:
    """[Ta, Tb] squared distance between two sets of boxes (0 if overlap)."""
    d = (amin[:, None, :] - bmax[None, :, :]).clamp(min=0.0) \
        + (bmin[None, :, :] - amax[:, None, :]).clamp(min=0.0)
    return torch.sum(d * d, dim=-1)


def sort_and_pad(query: torch.Tensor, ref: torch.Tensor, tq: int, tr: int):
    """Morton-sort both clouds over their shared bounds and pad them to whole
    tiles: (qs [nq * tq, 3], rs [nr * tr, 3], q_perm [N], r_perm [M]).
    Padded queries repeat the last sorted query; padded refs sit at 1e15, so
    the last ref tile's box reaches 1e15 and is never pruned."""
    lo = torch.minimum(query.amin(dim=0), ref.amin(dim=0))
    hi = torch.maximum(query.amax(dim=0), ref.amax(dim=0))
    inv_extent = 1.0 / (hi - lo).clamp(min=1e-6)
    q_perm = torch.sort(morton_codes(query, lo, inv_extent),
                        stable=True).indices
    r_perm = torch.sort(morton_codes(ref, lo, inv_extent), stable=True).indices
    qs, rs = query[q_perm], ref[r_perm]
    n_pad = (-query.shape[0]) % tq
    m_pad = (-ref.shape[0]) % tr
    if n_pad:
        qs = torch.cat([qs, qs[-1:].expand(n_pad, 3)])
    if m_pad:
        rs = torch.cat([rs, rs.new_full((m_pad, 3), _FAR)])
    return qs.contiguous(), rs.contiguous(), q_perm, r_perm


def window_mask(nq: int, nr: int, window: int,
                device: torch.device) -> torch.Tensor:
    """[nq, nr] bool: the ``window`` ref tiles around each query tile's
    proportional position, which pass 1 visits."""
    qi = torch.arange(nq, dtype=torch.float32, device=device)
    center = (((qi + 0.5) * (nr / nq)).to(torch.int32) - window // 2).clamp(
        0, max(nr - window, 0))
    j = torch.arange(nr, device=device)[None, :]
    return (j >= center[:, None]) & (j < center[:, None] + window)


def prune_mask(qs: torch.Tensor, rs: torch.Tensor, d1: torch.Tensor, k: int,
               tq: int, tr: int) -> torch.Tensor:
    """[nq, nr] bool: ref tiles whose box lies farther from the query tile's
    box than the tile's worst k-th distance after pass 1."""
    ub = d1[:, k - 1].reshape(-1, tq).amax(dim=1)
    qmin, qmax = _tile_bboxes(qs, tq)
    rmin, rmax = _tile_bboxes(rs, tr)
    return _bbox_sq_dist(qmin, qmax, rmin, rmax) > ub[:, None]


def _pruned_knn_single(query: torch.Tensor, ref: torch.Tensor, k: int,
                       tq: int = 512, tr: int = 2048, window: int = 2
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One cloud's exact pruned kNN: query [N, 3], ref [M, 3] -> (sq_dists
    [N, k] float32 >= 0, indices [N, k] int32)."""
    N, M = query.shape[0], ref.shape[0]
    query, ref = query.float(), ref.float()
    qs, rs, q_perm, r_perm = sort_and_pad(query, ref, tq, tr)
    nq, nr = qs.shape[0] // tq, rs.shape[0] // tr

    in_window = window_mask(nq, nr, window, query.device)
    d0 = qs.new_full((qs.shape[0], k), _BIG)
    i0 = torch.zeros((qs.shape[0], k), dtype=torch.int32, device=qs.device)
    d1, i1 = knn_pruned_pass(qs, rs, (~in_window).int().contiguous(), d0, i0,
                             k, tq, tr)
    skip2 = prune_mask(qs, rs, d1, k, tq, tr) | in_window
    d2, i2 = knn_pruned_pass(qs, rs, skip2.int().contiguous(), d1, i1, k, tq,
                             tr)

    # padded refs' positions clip to the last real sorted ref; then back to
    # ref ids and to the queries' own order
    i_orig = r_perm[i2[:N].long().clamp(max=M - 1)]
    d_un = torch.empty((N, k), dtype=torch.float32, device=query.device)
    i_un = torch.empty((N, k), dtype=torch.int32, device=query.device)
    d_un[q_perm] = d2[:N]
    i_un[q_perm] = i_orig.int()
    return d_un.clamp(min=0.0), i_un


def knn_pruned(query: torch.Tensor, ref: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched exact pruned kNN (``pallas_knn_pruned``): query [B, N, 3], ref
    [B, M, 3] -> (sq_dists [B, N, k], indices [B, N, k])."""
    outs = [_pruned_knn_single(q, r, k) for q, r in zip(query, ref)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
