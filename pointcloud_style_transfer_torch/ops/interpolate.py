"""kNN inverse-distance upsampling, coarse -> full resolution (counterpart of
``pointcloud_style_transfer_tpu/ops/interpolate.py``).

* known points (the coarse indices) receive their coarse value verbatim;
* every point is interpolated from its k=3 nearest *known* points, measured
  in the original geometry, weighted by 1/(euclidean distance + 1e-8),
  normalised; the known slots are then overwritten with their exact values.

``knn_interpolate_weights`` is separate from ``apply_interpolation`` so that
a caller that upsamples several value fields over one geometry pays for the
N x M distance pass once.
"""

from __future__ import annotations

import torch

from .distance import knn
from .sampling import index_points


def knn_interpolate_weights(original_points: torch.Tensor,
                            coarse_indices: torch.Tensor, k: int = 3,
                            backend: str = "pallas"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour indices + normalised inverse-distance weights.

    original_points [B, N, 3] full-resolution geometry, coarse_indices [B, M]
    the known points within it -> (nbr [B, N, k] int32 indices into the coarse
    set, w [B, N, k] float32). ``backend`` is ``ops.knn``'s."""
    k = min(k, coarse_indices.shape[1])
    ref_xyz = index_points(original_points, coarse_indices)
    sq_d, nbr = knn(original_points, ref_xyz, k, backend=backend)
    dist = torch.sqrt(torch.clamp(sq_d, min=0.0))
    w = 1.0 / (dist + 1e-8)
    return nbr, w / torch.sum(w, dim=-1, keepdim=True)


def apply_interpolation(coarse_values: torch.Tensor, nbr: torch.Tensor,
                        w: torch.Tensor, coarse_indices: torch.Tensor
                        ) -> torch.Tensor:
    """Apply precomputed kNN weights to coarse_values [B, M, C], then restore
    the exact values at the known slots (indices clipped to [0, N-1]).
    Returns [B, N, C] in ``coarse_values``' dtype."""
    N = nbr.shape[1]
    out = torch.sum(index_points(coarse_values, nbr) * w[..., None], dim=2)
    out = out.to(coarse_values.dtype)
    idx = coarse_indices.long().clamp(0, N - 1)
    return out.scatter_(1, idx[..., None].expand_as(coarse_values),
                        coarse_values)


def knn_interpolate(coarse_values: torch.Tensor,
                    original_points: torch.Tensor,
                    coarse_indices: torch.Tensor, k: int = 3,
                    backend: str = "pallas") -> torch.Tensor:
    """Scatter coarse_values [B, M, C] to their slots among original_points
    [B, N, 3] and kNN-interpolate the rest: [B, N, C]."""
    nbr, w = knn_interpolate_weights(original_points, coarse_indices, k,
                                     backend)
    return apply_interpolation(coarse_values, nbr, w, coarse_indices)
