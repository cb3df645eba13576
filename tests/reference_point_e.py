"""A plain float32 reference of Point-E's point-diffusion transformer as the
noise predictor, for the port's tests: written from Point-E's
``point_e/models/transformer.py`` (``PointDiffusionTransformer``,
``QKVMultiheadAttention``, ``timestep_embedding``; token conditioning as
in ``CLIPImagePointDiffusionTransformer``), einsum for einsum, over a dict
of weights by the port's state-dict names. Departures, as the port's:
3 input and 3 output channels, the style vector as the first token in
place of CLIP's (not rescaled by sqrt(d)), zeros for the unconditional
copy.

``PointERef`` is a net for ``h100_bench/reference/sampler.py::
guided_transfer(net=...)``: the style encoder of the benchmark's plain
``reference/networks.py`` and this transformer. ``train_losses`` is the
training loss of one mini-step, its gradients by autograd.

Float32, TF32 off; no kernel of the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from h100_bench.reference import geometry
from h100_bench.reference.networks import Net
from h100_bench.reference.sampler import alphas_cumprod, voxel_select

P = "noise_predictor"


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(0, half, dtype=torch.float32) / half)
    args = t[:, None].float() * freqs[None].to(t.device)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class PointERef:
    """Point-E's transformer over ``w`` (float32), ``heads`` heads, with
    the style encoder of ``networks.Net`` over the same weights.

    ``layout`` says how ``c_qkv``'s output splits: ``"head_major"``
    (Point-E's: per head [q | k | v]) or ``"qkv_major"`` ([Q | K | V], a
    wrong reading the tests tell apart). ``window``, when set, restricts
    each token's attention to its own window of ``window`` tokens in token
    order (a planted fault)."""

    def __init__(self, w: Dict[str, torch.Tensor], heads: int,
                 feature_dim: int, time_embed_dim: int = 128,
                 layout: str = "head_major", window: Optional[int] = None):
        self.w, self.heads = w, heads
        self.layout, self.window = layout, window
        self.encoder = Net(w, "fp32", feature_dim, time_embed_dim)
        self.width = w[f"{P}.input_proj.weight"].shape[0]
        self.layers = len({k.split(".")[3] for k in w
                           if k.startswith(f"{P}.backbone.resblocks.")})

    def encode_style(self, cloud, fps_starts, train=False, dropout_keep=None):
        return self.encoder.encode_style(cloud, fps_starts, train,
                                         dropout_keep)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w[f"{P}.{name}.weight"].t() + \
            self.w[f"{P}.{name}.bias"]

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.layer_norm(
            x, (x.shape[-1],), self.w[f"{P}.{name}.weight"],
            self.w[f"{P}.{name}.bias"], 1e-5)

    def mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        h = torch.nn.functional.gelu(self.linear(f"{name}.c_fc", x))
        return self.linear(f"{name}.c_proj", h)

    def attention(self, qkv: torch.Tensor) -> torch.Tensor:
        bs, n_ctx, width = qkv.shape
        attn_ch = width // self.heads // 3
        scale = 1 / math.sqrt(math.sqrt(attn_ch))
        if self.layout == "head_major":
            qkv = qkv.view(bs, n_ctx, self.heads, -1)
            q, k, v = torch.split(qkv, attn_ch, dim=-1)
        else:
            q, k, v = (z.reshape(bs, n_ctx, self.heads, attn_ch)
                       for z in qkv.chunk(3, dim=-1))
        weight = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        if self.window:
            blocks = torch.arange(n_ctx, device=qkv.device) // self.window
            weight = weight.masked_fill(blocks[:, None] != blocks[None, :],
                                        float("-inf"))
        weight = torch.softmax(weight.float(), dim=-1)
        return torch.einsum("bhts,bshc->bthc", weight, v).reshape(
            bs, n_ctx, -1)

    def predict_noise(self, x: torch.Tensor, t: torch.Tensor,
                      style: torch.Tensor, **unused) -> torch.Tensor:
        x, style = x.float(), style.float()
        h = self.linear("input_proj", x)
        s = self.linear("style_embed", style)
        tau = self.mlp("time_embed", timestep_embedding(t, self.width))
        h = torch.cat([s[:, None], tau[:, None], h], dim=1)
        h = self.layer_norm("ln_pre", h)
        for i in range(self.layers):
            b = f"backbone.resblocks.{i}"
            h = h + self.linear(f"{b}.attn.c_proj", self.attention(
                self.linear(f"{b}.attn.c_qkv",
                            self.layer_norm(f"{b}.ln_1", h))))
            h = h + self.mlp(f"{b}.mlp", self.layer_norm(f"{b}.ln_2", h))
        h = self.layer_norm("ln_post", h)
        return self.linear("output_proj", h[:, 2:])


def _min_sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        _, idx = geometry.nearest(q.detach(), r.detach(), 1)
    diff = q - r[idx[:, 0]]
    return (diff * diff).sum(dim=-1)


def train_losses(net: PointERef, cfg, sim: torch.Tensor, real: torch.Tensor,
                 draws: dict) -> torch.Tensor:
    """One training mini-step's loss (the port's ``compute_losses`` in
    train mode, hierarchical): L1 of the predicted noise at the noisy
    cloud's voxel downsample plus ``lambda_chamfer`` times the batch mean
    of the squared-L2 Chamfer distance between the predicted and the clean
    downsampled points; the style encoder in train mode, the condition
    drop by ``drop_u``. No dropout in the transformer."""
    M = cfg.global_points
    B = sim.shape[0]
    ac = alphas_cumprod(cfg.num_timesteps, cfg.noise_schedule_offset)
    t = draws["t"].long()
    a = torch.sqrt(ac[t])[:, None, None]
    b = torch.sqrt(1.0 - ac[t])[:, None, None]
    noisy = a * sim + b * draws["noise"]
    cond = torch.stack([real[i][voxel_select(real[i],
                                             draws["cond_priority"][i], M)]
                        for i in range(B)])
    style = net.encode_style(cond, draws["fps_starts"], train=True,
                             dropout_keep=draws["style_dropout_mask"])
    style = style * (draws["drop_u"] > cfg.cond_drop_prob).float()
    sel = torch.stack([voxel_select(noisy[i].detach(),
                                    draws["noisy_priority"][i], M)
                       for i in range(B)])
    rows = torch.arange(B)[:, None]
    x = noisy[rows, sel]
    pred = net.predict_noise(x, t, style)
    noise_loss = torch.mean(torch.abs(pred - draws["noise"][rows, sel]))
    x0 = (x - b * pred) / (a + 1e-8)
    clean = sim[rows, sel]
    chamfer = torch.stack([_min_sq_dist(x0[i], clean[i]).mean()
                           + _min_sq_dist(clean[i], x0[i]).mean()
                           for i in range(B)]).mean()
    return noise_loss + cfg.lambda_chamfer * chamfer
