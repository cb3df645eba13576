"""Plain-PyTorch reference of the classifier-free-guided DDIM style
transfer, from the system's published description (the reference
repository's ``models/diffusion_model.py`` sampler and
``scripts/inference.py``):

* the cosine noise schedule of 1,000 steps (offset 0.008 plus the
  configured one, over 1.008; betas clipped to [1e-4, 0.9999]; float64,
  then float32) and 50 DDIM timesteps from 999 down to 0, truncated;
* the style vector of the reference cloud, downsampled by the voxel rule
  to ``global_points`` first;
* each step, at the state's own resolution (direct) or on a voxel
  downsample of it (hierarchical): the denoiser on the conditioned and the
  unconditioned (zero style) copies, ``uncond + g * (cond - uncond)``; in
  the hierarchical mode the unselected points take the inverse-distance
  mean (weights 1 / (d + 1e-8), k = 3) of their nearest selected points;
* the deterministic DDIM update, with the predicted clean cloud pulled
  toward the source by the content anchor and clamped by
  ``tanh(x / r) * r``.

The random draws (initial noise, voxel priorities, FPS starts) are the
caller's: the benchmark makes them and hands the same to the program.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import geometry
from .networks import Net


def alphas_cumprod(num_timesteps: int, offset: float) -> torch.Tensor:
    """The cosine schedule's cumulative alphas, float32 [T]."""
    x = np.linspace(0, num_timesteps, num_timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / num_timesteps) + 0.008 + offset) / 1.008
                * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1.0 - ac[1:] / ac[:-1], 0.0001, 0.9999).astype(
        np.float32)
    alphas = 1.0 - torch.from_numpy(betas)
    return torch.cumprod(alphas.double(), dim=0).float()


def ddim_timesteps(num_timesteps: int, steps: int) -> list:
    """(t, t_prev) pairs, t_prev -1 at the last step."""
    ts = np.linspace(num_timesteps - 1, 0, steps).astype(np.int64).tolist()
    prev = ts[1:] + [-1]
    return [(t, p if t > 0 else -1) for t, p in zip(ts, prev)]


def ddim_update(ac: torch.Tensor, x: torch.Tensor, eps: torch.Tensor,
                t: int, t_prev: int, source: torch.Tensor, anchor: float,
                target_range: float) -> torch.Tensor:
    a_t = ac[t]
    a_prev = ac[t_prev] if t_prev >= 0 else torch.ones_like(a_t)
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / (torch.sqrt(a_t) + 1e-8)
    if anchor > 0:
        x0 = x0 + anchor * (source - x0)
    x0 = torch.tanh(x0 / target_range) * target_range
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def voxel_select(cloud: torch.Tensor, u: torch.Tensor, target: int
                 ) -> torch.Tensor:
    """Indices [target] of one cloud's voxel downsample."""
    return geometry.voxel_priority_order(cloud, u, target)[:target]


def idw_upsample(query: torch.Tensor, ref: torch.Tensor,
                 values: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-distance mean of the values of each query's k nearest refs."""
    d2, idx = geometry.nearest(query, ref, k)
    w = 1.0 / (torch.sqrt(d2.clamp_min(0.0)) + 1e-8)
    w = w / w.sum(dim=1, keepdim=True)
    return (values[idx] * w[..., None]).sum(dim=1)


@torch.no_grad()
def guided_transfer(weights: Dict[str, torch.Tensor], cfg: dict,
                    source: torch.Tensor, reference: torch.Tensor,
                    draws: Dict[str, torch.Tensor], steps: int,
                    guidance: float, hierarchical: bool,
                    precision: str = "fp32",
                    net: Optional[Net] = None) -> torch.Tensor:
    """One cloud's style transfer: ``source`` [N, 3] toward the style of
    ``reference`` [Nc, 3], both normalised; returns [N, 3] float32.

    ``draws``: ``x_init`` [N, 3], ``cond_priority`` [Nc], ``fps_starts``
    [2], ``step_priorities`` [steps, N] (hierarchical)."""
    M = int(cfg["global_points"])
    net = net or Net(weights, precision, int(cfg["feature_dim"]),
                     int(cfg["time_embed_dim"]))
    ac = alphas_cumprod(int(cfg["num_timesteps"]),
                        float(cfg["noise_schedule_offset"])).to(source.device)
    anchor, rng = float(cfg["content_anchor"]), float(cfg["target_range"])
    cond = reference.float()
    if cond.shape[0] > M:
        cond = cond[voxel_select(cond, draws["cond_priority"], M)]
    style = net.encode_style(cond[None], draws["fps_starts"].reshape(2, 1))
    style2 = torch.cat([style, torch.zeros_like(style)])
    source = source.float()
    x = draws["x_init"].float()
    N = x.shape[0]
    for s, (t, t_prev) in enumerate(ddim_timesteps(
            int(cfg["num_timesteps"]), steps)):
        t2 = torch.full((2,), t, dtype=torch.int64, device=x.device)
        if hierarchical and N > M:
            order = geometry.voxel_priority_order(
                x, draws["step_priorities"][s], M)
            sel, rest = order[:M], order[M:]
            pred = net.predict_noise(x[sel][None].expand(2, -1, -1), t2,
                                     style2)
            coarse = pred[1] + guidance * (pred[0] - pred[1])
            eps = torch.empty_like(x)
            eps[sel] = coarse
            eps[rest] = idw_upsample(x[rest], x[sel], coarse)
        else:
            pred = net.predict_noise(x[None].expand(2, -1, -1), t2, style2)
            eps = pred[1] + guidance * (pred[0] - pred[1])
        x = ddim_update(ac, x, eps, t, t_prev, source, anchor, rng)
    return x
