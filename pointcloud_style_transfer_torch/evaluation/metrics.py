"""Evaluation metrics (counterpart of
``pointcloud_style_transfer_tpu/evaluation/metrics.py``), same definitions:

* chamfer_distance — UNSQUARED L2, averaged over both directions and
  divided by 2 (unlike the squared training loss);
* hausdorff_distance — max-of-min both ways;
* coverage_score — fraction of target points with a predicted point within a
  threshold;
* uniformity_score — 1/(1+CV) of per-point mean k-NN distances;
* fidelity_score — cosine similarity of per-cloud (mean, std) features, or
  of features from a given extractor;
* precision_recall_f1 — at a distance threshold (0.2 m);
* earth_mover_distance_greedy — the reference's greedy matching (numpy);
* earth_mover_distance — Sinkhorn-regularised OT in plain PyTorch (the JAX
  package has no kernel for it either).

The row minima of chamfer, hausdorff, coverage and precision/recall go
through ``ops.min_sq_dist``: on CUDA tensors the row-min kernel, since no
gradient is taken. Uniformity's kNN is the brute-force kNN kernel at k+1.
With a ``mesh`` whose ``points`` axis has more than one rank, the Chamfer
runs point-sharded on a ring of those ranks (``parallel/ring.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import chamfer_distance_l2, knn, min_sq_dist, square_distance


def chamfer_distance(pred: torch.Tensor, target: torch.Tensor,
                     bidirectional: bool = True, mesh=None,
                     backend: str = "pallas") -> torch.Tensor:
    """[B] unsquared-L2 Chamfer.

    With a ``mesh`` (``parallel.make_mesh``) whose ``points`` axis has n > 1
    ranks, and point counts that n divides, every rank passes the same
    clouds, takes its contiguous 1/n of each, and the ring
    (``parallel.ring.ring_chamfer_distance_l2``) computes the row minima;
    every rank returns the same [B]. Other counts take the dense path, as
    in the JAX package. The ring needs the axis's ranks to call together."""
    if mesh is not None and bidirectional:
        from ..parallel.mesh import POINTS_AXIS, axis_size, local_slice
        n = axis_size(mesh, POINTS_AXIS)
        if n > 1 and pred.shape[1] % n == 0 and target.shape[1] % n == 0:
            from ..parallel.ring import ring_chamfer_distance_l2
            return ring_chamfer_distance_l2(
                local_slice(pred, 1, mesh, POINTS_AXIS),
                local_slice(target, 1, mesh, POINTS_AXIS), mesh)
    if bidirectional:
        return chamfer_distance_l2(pred, target, backend)
    return torch.sqrt(min_sq_dist(pred, target, backend)).mean(dim=1)


def hausdorff_distance(pred: torch.Tensor, target: torch.Tensor,
                       backend: str = "pallas") -> torch.Tensor:
    """[B] symmetric Hausdorff."""
    d_pt = torch.sqrt(min_sq_dist(pred, target, backend))
    d_tp = torch.sqrt(min_sq_dist(target, pred, backend))
    return torch.maximum(d_pt.amax(dim=1), d_tp.amax(dim=1))


def coverage_score(pred: torch.Tensor, target: torch.Tensor,
                   threshold: float = 0.01,
                   backend: str = "pallas") -> torch.Tensor:
    """Mean fraction of target points whose nearest predicted point is closer
    than ``threshold``."""
    d = torch.sqrt(min_sq_dist(target, pred, backend))  # [B, M]
    return (d < threshold).float().mean(dim=1).mean()


def uniformity_score(points: torch.Tensor, k: int = 8,
                     backend: str = "pallas") -> torch.Tensor:
    """1/(1+CV) of the per-point mean kNN distance, averaged over the batch.
    The self-neighbour is dropped by querying k+1."""
    d, _ = knn(points, points, k + 1, backend)
    d = torch.sqrt(d[..., 1:].clamp_min(0.0))
    mean_d = d.mean(dim=-1)  # [B, N]
    mu = mean_d.mean(dim=1)
    sigma = mean_d.std(dim=1, unbiased=False)
    cv = torch.where(mu > 0, sigma / mu, torch.full_like(mu, float("inf")))
    return torch.where(mu > 0, 1.0 / (1.0 + cv), torch.zeros_like(mu)).mean()


def fidelity_score(pred: torch.Tensor, target: torch.Tensor,
                   feature_extractor=None) -> float:
    """Cosine similarity of (mean, std) stat features or of encoder
    features."""
    if feature_extractor is None:
        pf = torch.cat([pred.mean(dim=1), pred.std(dim=1)], -1)
        tf = torch.cat([target.mean(dim=1), target.std(dim=1)], -1)
    else:
        pf = feature_extractor(pred)
        tf = feature_extractor(target)
    num = torch.sum(pf * tf, dim=1)
    den = torch.linalg.norm(pf, dim=1) * torch.linalg.norm(tf, dim=1) + 1e-8
    return float(torch.mean(num / den))


def earth_mover_distance_greedy(pred: np.ndarray,
                                target: np.ndarray) -> np.ndarray:
    """The reference's greedy matching EMD approximation: for each predicted
    point in order, match the nearest unused target point. Numpy, O(N^2)
    memory: small clouds and parity checks."""
    if pred.shape != target.shape:
        raise ValueError(f"shapes differ: {pred.shape} vs {target.shape}")
    B, N, _ = pred.shape
    out = np.zeros(B, np.float64)
    for b in range(B):
        d = np.linalg.norm(pred[b][:, None, :] - target[b][None, :, :],
                           axis=-1)
        used = np.zeros(N, bool)
        total = 0.0
        for i in range(N):
            row = np.where(used, np.inf, d[i])
            j = int(np.argmin(row))
            total += row[j]
            used[j] = True
        out[b] = total / N
    return out


def earth_mover_distance(pred: torch.Tensor, target: torch.Tensor,
                         epsilon: float = 0.01, num_iters: int = 100,
                         max_points: int = 8192,
                         generator: Optional[torch.Generator] = None,
                         perms: Optional[tuple] = None) -> torch.Tensor:
    """Sinkhorn EMD with subsampling: the cost matrix is dense (N x M), so
    clouds larger than ``max_points`` are uniformly subsampled first, with
    the permutations ``perms`` (pred's, target's) or ones drawn from
    ``generator``."""
    def maybe_sub(x, perm):
        n = x.shape[1]
        if n <= max_points:
            return x
        if perm is None:
            perm = torch.randperm(n, generator=generator, device=x.device)
        return x[:, perm.to(x.device)[:max_points]]

    p_perm, t_perm = perms if perms is not None else (None, None)
    return _sinkhorn_emd(maybe_sub(pred, p_perm), maybe_sub(target, t_perm),
                         epsilon, num_iters)


def _sinkhorn_emd(pred: torch.Tensor, target: torch.Tensor,
                  epsilon: float = 0.01, num_iters: int = 100) -> torch.Tensor:
    """Entropic-regularised OT transport cost per batch element, log-domain
    updates."""
    B, N, _ = pred.shape
    M = target.shape[1]
    C = torch.sqrt(square_distance(pred, target).clamp_min(0.0))  # [B,N,M]
    log_a = torch.full((B, N), -float(np.log(N)), device=C.device)
    log_b = torch.full((B, M), -float(np.log(M)), device=C.device)
    f = torch.zeros((B, N), device=C.device)
    g = torch.zeros((B, M), device=C.device)
    for _ in range(num_iters):
        f = -epsilon * torch.logsumexp(
            (g[:, None, :] - C) / epsilon + log_b[:, None, :], dim=2)
        g = -epsilon * torch.logsumexp(
            (f[:, :, None] - C) / epsilon + log_a[:, :, None], dim=1)
    logP = ((f[:, :, None] + g[:, None, :] - C) / epsilon
            + log_a[:, :, None] + log_b[:, None, :])
    # P has total mass 1, so sum(P*C) is the mean per-point transport cost
    return torch.sum(torch.exp(logP) * C, dim=(1, 2))


def precision_recall_f1(generated: torch.Tensor, reference: torch.Tensor,
                        threshold: float = 0.2, backend: str = "pallas"):
    """(precision, recall, F1) at a distance threshold: precision = fraction
    of generated points with a reference point within threshold; recall =
    the reverse."""
    d_gr = torch.sqrt(min_sq_dist(generated, reference, backend))
    d_rg = torch.sqrt(min_sq_dist(reference, generated, backend))
    precision = (d_gr < threshold).float().mean()
    recall = (d_rg < threshold).float().mean()
    s = precision + recall
    f1 = torch.where(s > 0, 2 * precision * recall / s, torch.zeros_like(s))
    return precision, recall, f1


class PointCloudMetrics:
    """Class facade over the metric functions. ``device`` (default ``cuda``;
    raises without a card unless ``"cpu"``) is where ``as_tensor`` puts the
    clouds that the methods take."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)

    def as_tensor(self, points) -> torch.Tensor:
        """A cloud (numpy or tensor) as float32 on this object's device."""
        return torch.as_tensor(points, dtype=torch.float32,
                               device=self.device)

    chamfer_distance = staticmethod(chamfer_distance)
    hausdorff_distance = staticmethod(hausdorff_distance)
    coverage_score = staticmethod(coverage_score)
    uniformity_score = staticmethod(uniformity_score)
    fidelity_score = staticmethod(fidelity_score)
    earth_mover_distance = staticmethod(earth_mover_distance)
    earth_mover_distance_greedy = staticmethod(earth_mover_distance_greedy)
