"""Plain-PyTorch forward of Point-E's point-diffusion transformer as the
style-transfer network's noise predictor, from its published description
(https://github.com/openai/point-e, ``point_e/models/transformer.py``:
``PointDiffusionTransformer`` with token conditioning as in
``CLIPImagePointDiffusionTransformer``; widths from
``point_e/models/configs.py``). With width d, H heads of c = d / H
channels and L blocks, on M noisy points x [B, M, 3]:

* tokens ``[s, tau, h]``: the style token ``s = style_embed(style)``, the
  time token ``tau = time_embed.c_proj(gelu(time_embed.c_fc(temb(t))))``
  with ``temb = cat(cos(t f), sin(t f))``, ``f_i = exp(-ln(1e4) i /
  (d / 2))``, and ``h = input_proj(x)``; no positional encoding;
* ``ln_pre``; L blocks ``h += attn.c_proj(attn(attn.c_qkv(ln_1(h))))``,
  ``h += mlp.c_proj(gelu(mlp.c_fc(ln_2(h))))``, LayerNorm affine with eps
  1e-5, exact GELU;
* attention: ``c_qkv``'s output viewed as [B, T, H, 3c], split per head
  into q, k, v; q and k each scaled by c^(-1/4); softmax over all T tokens
  in float32, no mask; computed a few heads at a time, so that the
  [B, heads, T, T] weights fit;
* ``ln_post``, the first two tokens dropped, ``output_proj`` (d -> 3).

Departures from Point-E, as the configuration file states them: 3 input
channels (no colour), 3 output channels (the noise alone, the sampler
being DDIM), the style vector of ``networks.Net``'s encoder in place of
CLIP's and not rescaled by sqrt(d), zeros for the unconditional copy, and
seeded weights with a non-zero ``output_proj``.

``PointENet(weights, cfg, precision)`` has the two calls
``sampler.guided_transfer(net=...)`` makes: ``encode_style`` (``networks.
Net``'s) and ``predict_noise``. ``pinned_transfer`` is that sampler with
each step's discrete choices (the voxel order, the upsample's neighbours)
given: with full attention over the downsample, one voxel representative
that flips on rounding changes a token that every point attends to, so
two honest runs of the sampler part at once; given the same choices, they
differ by rounding alone. ``choice_misses`` holds such given choices to
the reference's own rules: the voxel rule with the step's draw, and the
float32 three nearest neighbours. Precisions as ``networks.py``'s:
``"fp32"`` (the reference: every product in float32, TF32 off);
``"bf16"``, the configuration's: a dense layer's operands and output,
LayerNorm's and GELU's outputs, the residual sums, and attention's q, k, v,
its softmax weights (the second product's operand) and its output rounded
to bfloat16, products summed in float32; ``"fp8"``, the control: the dense
layers' and attention's product operands in float8 e4m3, one scale a
tensor, the rest as ``"bf16"``.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import sampler as ref_sampler
from .networks import Net, _bf16, _fp8

Weights = Dict[str, torch.Tensor]
P = "noise_predictor"
LN_EPS = 1e-5
HEAD_BLOCK = 4  # heads a weight matrix [B, HEAD_BLOCK, T, T] at a time
# a given neighbour may lie this much (relative) past the third-nearest:
# the rounding of the program's float32 distance form
KNN_RTOL = 1e-4
KNN_ROWS = 2048  # query rows a [rows, M] block of distances at a time


class PointENet:
    """The style encoder of ``networks.Net`` and Point-E's transformer over
    ``weights`` at ``precision``; ``cfg`` is the configuration file's dict
    (its ``denoiser`` entry gives width, layers, heads and MLP ratio)."""

    def __init__(self, weights: Weights, cfg: dict, precision: str = "fp32"):
        self.net = Net(weights, precision, int(cfg["feature_dim"]),
                       int(cfg["time_embed_dim"]))
        spec = cfg["denoiser"]
        self.w, self.precision = weights, precision
        self.width, self.layers = int(spec["width"]), int(spec["layers"])
        self.heads = int(spec["heads"])

    def encode_style(self, cloud, fps_starts, train=False, dropout_keep=None):
        return self.net.encode_style(cloud, fps_starts, train, dropout_keep)

    # -- the pieces -----------------------------------------------------------
    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.net.dense(f"{P}.{name}", x)

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        return self.net.rounded(x)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand as the precision holds it."""
        if self.precision == "fp32":
            return x
        return _fp8(x) if self.precision == "fp8" else _bf16(x)

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + LN_EPS)
        return self.rounded(y * self.w[f"{P}.{name}.weight"]
                            + self.w[f"{P}.{name}.bias"])

    def gelu(self, x: torch.Tensor) -> torch.Tensor:
        return self.rounded(0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))))

    def mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.dense(f"{name}.c_proj", self.gelu(
            self.dense(f"{name}.c_fc", x)))

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        half = self.width // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, dtype=torch.float32) / half)
        args = t.float()[:, None] * freqs.to(t.device)[None, :]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    def attention(self, qkv: torch.Tensor) -> torch.Tensor:
        """[B, T, 3d] head-major -> [B, T, d]."""
        B, T, _ = qkv.shape
        H = self.heads
        c = self.width // H
        scale = 1.0 / math.sqrt(math.sqrt(c))
        q, k, v = qkv.float().view(B, T, H, 3 * c).split(c, dim=-1)
        out = []
        for h0 in range(0, H, HEAD_BLOCK):
            hs = slice(h0, min(H, h0 + HEAD_BLOCK))
            qh = q[:, :, hs].transpose(1, 2)  # [B, h, T, c]
            kh = k[:, :, hs].transpose(1, 2)
            vh = v[:, :, hs].transpose(1, 2)
            if self.precision == "fp32":
                s = torch.matmul(qh * scale, (kh * scale).transpose(-1, -2))
            else:  # the fused kernel's scale: one factor after the product
                s = torch.matmul(self.operand(qh), self.operand(
                    kh).transpose(-1, -2)) * (scale * scale)
            p = torch.softmax(s, dim=-1)
            out.append(torch.matmul(self.operand(p), self.operand(vh)))
            del s, p
        o = torch.cat(out, dim=1).transpose(1, 2).reshape(B, T, H * c)
        return self.rounded(o)

    # -- the network ----------------------------------------------------------
    def predict_noise(self, x: torch.Tensor, t: torch.Tensor,
                      style: torch.Tensor) -> torch.Tensor:
        """Noise [B, M, 3] of points [B, M, 3] at timesteps ``t`` [B] under
        style vectors [B, feature_dim]."""
        h = self.dense("input_proj", x)
        s = self.dense("style_embed", style)
        tau = self.mlp("time_embed", self.time_embedding(t))
        h = torch.cat([s[:, None], tau[:, None], h], dim=1)
        h = self.layer_norm("ln_pre", h)
        for i in range(self.layers):
            b = f"backbone.resblocks.{i}"
            a = self.attention(self.dense(f"{b}.attn.c_qkv",
                                          self.layer_norm(f"{b}.ln_1", h)))
            h = self.rounded(h + self.dense(f"{b}.attn.c_proj", a))
            h = self.rounded(h + self.mlp(f"{b}.mlp",
                                          self.layer_norm(f"{b}.ln_2", h)))
        h = self.layer_norm("ln_post", h)
        return self.dense("output_proj", h[:, 2:])


@torch.no_grad()
def choice_misses(x: torch.Tensor, priority: torch.Tensor, M: int,
                  order: torch.Tensor, neighbours: torch.Tensor
                  ) -> Tuple[int, int]:
    """One step's given choices held to the reference's rules on points
    x [N, 3]: (the points of the given downsample ``order[:M]`` that
    ``sampler.voxel_select`` with the draw ``priority`` [N] does not
    choose; the given ``neighbours`` [N - M, 3] of the points ``order[M:]``
    farther, in float32, than the third-nearest of the downsample's points
    by more than ``KNN_RTOL`` of it)."""
    order = order.long()
    sel, rest = order[:M], order[M:]
    chosen = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    chosen[ref_sampler.voxel_select(x, priority, M)] = True
    coarse = x[sel]
    knn = torch.zeros((), dtype=torch.int64, device=x.device)
    for r in range(0, rest.shape[0], KNN_ROWS):
        q = x[rest[r:r + KNN_ROWS]]
        d = torch.sqrt(((q[:, None, :] - coarse[None]) ** 2).sum(-1))
        third = d.topk(3, dim=1, largest=False).values[:, 2:]
        got = d.gather(1, neighbours[r:r + KNN_ROWS].long())
        knn += (got > third * (1.0 + KNN_RTOL)).sum()
    return int((~chosen[sel]).sum()), int(knn)


@torch.no_grad()
def pinned_transfer(net: PointENet, cfg: dict, source: torch.Tensor,
                    reference: torch.Tensor, draws: Dict[str, torch.Tensor],
                    steps: int, guidance: float, orders: torch.Tensor,
                    neighbours: torch.Tensor) -> torch.Tensor:
    """``sampler.guided_transfer`` (hierarchical) of one cloud with each
    step's choices given: ``orders`` [steps, N], every index in the voxel
    rule's order (its first ``global_points`` are the downsample, the rest
    the points interpolated, in that order), and ``neighbours``
    [steps, N - M, 3], each interpolated point's three nearest coarse
    points by their place in the downsample. Weights 1 / (d + 1e-8) of the
    float32 distances, normalised."""
    M = int(cfg["global_points"])
    ac = ref_sampler.alphas_cumprod(
        int(cfg["num_timesteps"]),
        float(cfg["noise_schedule_offset"])).to(source.device)
    anchor, rng = float(cfg["content_anchor"]), float(cfg["target_range"])
    cond = reference.float()
    if cond.shape[0] > M:
        cond = cond[ref_sampler.voxel_select(cond, draws["cond_priority"], M)]
    style = net.encode_style(cond[None], draws["fps_starts"].reshape(2, 1))
    style2 = torch.cat([style, torch.zeros_like(style)])
    source = source.float()
    x = draws["x_init"].float()
    for s, (t, t_prev) in enumerate(ref_sampler.ddim_timesteps(
            int(cfg["num_timesteps"]), steps)):
        t2 = torch.full((2,), t, dtype=torch.int64, device=x.device)
        order = orders[s].long()
        sel, rest = order[:M], order[M:]
        pred = net.predict_noise(x[sel][None].expand(2, -1, -1), t2, style2)
        coarse = pred[1] + guidance * (pred[0] - pred[1])
        nbr = neighbours[s].long()
        d = torch.sqrt(((x[rest][:, None, :] - x[sel][nbr]) ** 2).sum(-1))
        w = 1.0 / (d + 1e-8)
        w = w / w.sum(dim=1, keepdim=True)
        eps = torch.empty_like(x)
        eps[sel] = coarse
        eps[rest] = (coarse[nbr] * w[..., None]).sum(dim=1)
        x = ref_sampler.ddim_update(ac, x, eps, t, t_prev, source, anchor,
                                    rng)
    return x
