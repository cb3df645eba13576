"""Diffusion schedule and DDIM math (counterpart of
``pointcloud_style_transfer_tpu/models/diffusion.py``).

* cosine schedule in float64, cast to float32, with the reference's quirk of
  a hardcoded 0.008 PLUS the configured offset (denominator fixed at 1.008),
  betas clipped to [1e-4, 0.9999]; linear schedule linspace(1e-4, 0.02);
* ``q_sample``, the tanh ``geometric_constraint`` and the deterministic
  ``ddim_step`` with the content anchor applied before the tanh.

The float32 tables are computed once on the CPU and then moved to the
sampling device, so every device sees the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..config import Config


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(**{f.name: getattr(self, f.name).to(device)
                                    for f in fields(self)})


def make_beta_schedule(schedule_name: str, num_timesteps: int,
                       offset: float = 0.0) -> np.ndarray:
    """float32 betas; the cosine branch runs in float64 because the betas
    come from a cancellation (1 - ac[i+1]/ac[i]) that amplifies rounding."""
    if schedule_name == "cosine":
        x = np.linspace(0, num_timesteps, num_timesteps + 1, dtype=np.float64)
        ac = np.cos(((x / num_timesteps) + 0.008 + offset) / 1.008
                    * np.pi * 0.5) ** 2
        ac = ac / ac[0]
        betas = 1.0 - (ac[1:] / ac[:-1])
        return np.clip(betas, 0.0001, 0.9999).astype(np.float32)
    if schedule_name == "linear":
        return np.linspace(0.0001, 0.02, num_timesteps, dtype=np.float32)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def make_schedule(config: Config) -> DiffusionSchedule:
    """The float32 schedule on the CPU; ``.to(device)`` moves it."""
    betas = torch.from_numpy(make_beta_schedule(
        config.beta_schedule, config.num_timesteps,
        config.noise_schedule_offset))
    alphas = 1.0 - betas
    # float64 product, then float32: within 3e-8 of exact, where a float32
    # product drifts by ~3e-7 over 1000 terms (XLA's does too, in its own
    # order, so the two float32 tables would differ by a few ulps anyway)
    ac = torch.cumprod(alphas.double(), dim=0).float()
    ac_prev = torch.cat([torch.ones(1, dtype=ac.dtype), ac[:-1]])
    return DiffusionSchedule(
        betas=betas,
        alphas=alphas,
        alphas_cumprod=ac,
        alphas_cumprod_prev=ac_prev,
        sqrt_alphas_cumprod=torch.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=torch.sqrt(1.0 - ac),
    )


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward noising x_t = sqrt(ac_t) x_0 + sqrt(1-ac_t) eps."""
    t = t.long().clamp(0, schedule.num_timesteps - 1)
    a = schedule.sqrt_alphas_cumprod[t][:, None, None]
    b = schedule.sqrt_one_minus_alphas_cumprod[t][:, None, None]
    return a * x_start + b * noise


def geometric_constraint(points: torch.Tensor,
                         target_range: float = 1.8) -> torch.Tensor:
    """Soft clip to +-target_range."""
    return torch.tanh(points / target_range) * target_range


def ddim_timesteps(num_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Descending DDIM timesteps, truncated (not rounded) like
    torch.linspace(T-1, 0, n).long()."""
    return np.linspace(num_timesteps - 1, 0, num_inference_steps).astype(np.int64)


def ddim_step(schedule: DiffusionSchedule, x: torch.Tensor,
              predicted_noise: torch.Tensor, t: int, t_prev: int, *,
              source_points: torch.Tensor | None = None,
              content_anchor: float = 0.0,
              target_range: float = 1.8) -> torch.Tensor:
    """One deterministic (eta=0) DDIM update with the optional content-anchor
    pull toward ``source_points`` and the tanh constraint. ``t_prev < 0``
    means the final step (alpha_prev = 1)."""
    ac = schedule.alphas_cumprod
    alpha_t = ac[max(int(t), 0)]
    alpha_prev = ac[int(t_prev)] if t_prev >= 0 else torch.ones_like(alpha_t)

    sqrt_one_minus = torch.sqrt(1.0 - alpha_t)
    pred_x0 = (x - sqrt_one_minus * predicted_noise) / (torch.sqrt(alpha_t) + 1e-8)
    if source_points is not None and content_anchor > 0:
        pred_x0 = pred_x0 + content_anchor * (source_points - pred_x0)
    pred_x0 = geometric_constraint(pred_x0, target_range)

    dir_xt = torch.sqrt(1.0 - alpha_prev) * predicted_noise
    return torch.sqrt(alpha_prev) * pred_x0 + dir_xt
