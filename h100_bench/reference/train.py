"""Plain-PyTorch reference of the training mini-step, from the system's
published description (the reference repository's
``models/diffusion_model.py`` loss and ``training/trainer.py``): noise the
clean sim cloud to a drawn timestep, downsample both clouds by the voxel
rule, encode the style of the real cloud (train mode: batch statistics,
dropout), drop the style of a cloud where its draw says so, predict the
noise of the downsampled noisy cloud, and take

    L1(predicted, true noise at the selected points)
    + lambda * mean over the batch of the squared-L2 Chamfer distance
      between the predicted clean points and the clean selected points;

then the optimizer (optax's ``MultiSteps`` of clip-by-global-norm, Adam
(0.9, 0.95, eps 1e-8), weight decay and -1, the learning rate applied
after): gradients averaged over ``every_k`` mini-steps, one update per
``every_k``, and the EMA of the parameters (decay 0.999) moved on it.

The draws (timesteps, noise, voxel priorities, FPS starts, dropout masks,
the condition-drop uniforms) are the caller's; everything else is
recomputed here from the benchmark's weights. Float32 with TF32 off; the
gradients by autograd through this forward.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import geometry
from .networks import Net
from .sampler import alphas_cumprod, voxel_select

Weights = Dict[str, torch.Tensor]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8


def min_sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[Q] squared distance of each query to its nearest ref, with the
    gradient of the distance to that ref (the lowest index among equals)."""
    with torch.no_grad():
        _, idx = geometry.nearest(q.detach(), r.detach(), 1)
    diff = q - r[idx[:, 0]]
    return (diff * diff).sum(dim=-1)


def losses(net: Net, cfg: dict, sim: torch.Tensor, real: torch.Tensor,
           draws: dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"noise_loss", "chamfer_loss", "total_loss"}) of a batch of
    clean sim clouds [B, N, 3] and real clouds [B, Nc, 3]."""
    M = int(cfg["global_points"])
    B = sim.shape[0]
    ac = alphas_cumprod(int(cfg["num_timesteps"]),
                        float(cfg["noise_schedule_offset"])).to(sim.device)
    t = draws["t"].long()
    a = torch.sqrt(ac[t])[:, None, None]
    b = torch.sqrt(1.0 - ac[t])[:, None, None]
    noisy = a * sim + b * draws["noise"]
    cond = torch.stack([real[i][voxel_select(real[i],
                                             draws["cond_priority"][i], M)]
                        for i in range(B)])
    style = net.encode_style(cond, draws["fps_starts"], train=True,
                             dropout_keep=draws["style_dropout_mask"])
    keep = (draws["drop_u"] > float(cfg["cond_drop_prob"])).float()
    style = style * keep
    sel = torch.stack([voxel_select(noisy[i].detach(),
                                    draws["noisy_priority"][i], M)
                       for i in range(B)])
    rows = torch.arange(B, device=sim.device)[:, None]
    x = noisy[rows, sel]
    pred = net.predict_noise(x, t, style, train=True,
                             dropout_keep=draws["noise_dropout_masks"])
    noise_loss = torch.mean(torch.abs(pred - draws["noise"][rows, sel]))
    x0 = (x - b * pred) / (a + 1e-8)
    clean = sim[rows, sel]
    chamfer = torch.stack([min_sq_dist(x0[i], clean[i]).mean()
                           + min_sq_dist(clean[i], x0[i]).mean()
                           for i in range(B)]).mean()
    total = noise_loss + float(cfg["lambda_chamfer"]) * chamfer
    return total, {"noise_loss": noise_loss, "chamfer_loss": chamfer,
                   "total_loss": total}


class Trainer:
    """The parameters, optimizer state and EMA of the reference, stepped
    one mini-step at a time."""

    def __init__(self, weights: Weights, cfg: dict, precision: str = "fp32"):
        self.cfg = cfg
        self.state = {k: v.detach().clone().float()
                      for k, v in weights.items()}
        self.names = [k for k in self.state
                      if not k.endswith(("running_mean", "running_var"))]
        self.ema = {k: self.state[k].clone() for k in self.names}
        self.mu = {k: torch.zeros_like(self.state[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(self.state[k]) for k in self.names}
        self.acc = {k: torch.zeros_like(self.state[k]) for k in self.names}
        self.mini_step, self.count = 0, 0
        self.acc_norms = []  # the accumulated gradient's, at each step
        self.precision = precision

    def step(self, sim: torch.Tensor, real: torch.Tensor, draws: dict,
             lr: float) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        """One mini-step: (loss terms, this step's gradients by name)."""
        cfg = self.cfg
        params = {k: self.state[k].clone().requires_grad_(True)
                  for k in self.names}
        weights = {**self.state, **params}
        net = Net(weights, self.precision, int(cfg["feature_dim"]),
                  int(cfg["time_embed_dim"]))
        total, terms = losses(net, cfg, sim, real, draws)
        grads = torch.autograd.grad(total, [params[k] for k in self.names])
        grads = dict(zip(self.names, (g.detach() for g in grads)))
        for k, v in weights.items():  # BatchNorm's running statistics
            if k.endswith(("running_mean", "running_var")):
                self.state[k] = v.detach()
        self._apply(grads, lr)
        return {k: float(v.detach()) for k, v in terms.items()}, grads

    @torch.no_grad()
    def _apply(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        cfg = self.cfg
        k_every = int(cfg["gradient_accumulation_steps"])
        n = self.mini_step
        for k in self.names:
            self.acc[k] = self.acc[k] + (grads[k] - self.acc[k]) / (n + 1)
        self.mini_step = (n + 1) % k_every
        if n != k_every - 1:
            return
        norm = torch.sqrt(sum((a * a).sum() for a in self.acc.values()))
        max_norm = float(cfg["gradient_clip"])
        scale = 1.0 if float(norm) < max_norm else max_norm / float(norm)
        self.acc_norms.append(float(norm))
        self.count += 1
        c1 = 1 - ADAM_B1 ** self.count
        c2 = 1 - ADAM_B2 ** self.count
        decay = float(cfg["ema_decay"])
        for k in self.names:
            g = self.acc[k] * scale
            self.mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[k]
            self.nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * self.nu[k]
            update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                          + ADAM_EPS)
            update = update + float(cfg["weight_decay"]) * self.state[k]
            self.state[k] = self.state[k] - lr * update
            self.ema[k] = decay * self.ema[k] + (1 - decay) * self.state[k]
            self.acc[k] = torch.zeros_like(self.acc[k])

