"""Plain-PyTorch forward of the style-transfer network, from its published
description (the reference repository's ``models/pointnet2.py`` and
``models/diffusion_model.py``, channels last): a PointNet++ style encoder
(SA(512, 0.2, 32) -> SA(128, 0.4, 64) -> group-all, each a shared MLP of
1x1 convolutions with BatchNorm and ReLU, max-pooled) with a two-layer
head, and a per-point residual MLP denoiser conditioned on a sinusoidal
timestep embedding and the style vector.

Weights are a dict of float32 tensors by the names the benchmark gives
them (``<module>.<layer>.weight`` / ``.bias``, BatchNorm's ``weight``,
``bias``, ``running_mean``, ``running_var``). Every product runs in
float32 with TF32 off (``precision="fp32"``, the reference). Two lower
precisions round what a layer keeps: ``"bf16"``, the bfloat16 compute the
configuration states (operands, layer outputs, BatchNorm's outputs and
the denoiser's sums rounded to bfloat16, products summed in float32),
which gives the spread that rounding at the stated precision alone leaves
between two honest runs of a chaotic sampler; and ``"fp8"``, the
correctness control, as a float8 GEMM would run a layer: operands rounded
to float8 e4m3 with one scale a tensor, the rest as ``"bf16"`` -- the
step below the precision the configuration states.

Train mode (BatchNorm on the batch's statistics, the biased variance
max(0, E[x^2] - E[x]^2), running statistics moved by 0.9; dropout
``where(keep, x / 0.9, 0)`` on keep masks given by the caller) is what the
training reference differentiates.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from . import geometry

Weights = Dict[str, torch.Tensor]
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
KEEP_PROB = 0.9
FP8_MAX = 448.0  # float8 e4m3's largest finite value
SA_LAYERS = (("sa1", 512, 0.2, 32), ("sa2", 128, 0.4, 64))
DENOISER_BLOCKS = 6


def _rounded(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``q``, a rounding of ``x``, with ``x``'s gradient."""
    return x + (q - x).detach()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return _rounded(x, x.to(torch.bfloat16).float())


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    return _rounded(x, (x / scale).to(torch.float8_e4m3fn).float() * scale)


class Net:
    """The network's forward over ``weights`` at ``precision``."""

    def __init__(self, weights: Weights, precision: str = "fp32",
                 feature_dim: int = 256, time_embed_dim: int = 128):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.w = weights
        self.precision = precision
        self.feature_dim = feature_dim
        self.time_embed_dim = time_embed_dim

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        x = x.float()
        if self.precision == "fp32":
            return torch.matmul(x, w.t()) + b
        # float8 (or bfloat16) operands, float32 sums, the layer's output
        # in bfloat16
        low = _fp8 if self.precision == "fp8" else _bf16
        y = torch.matmul(low(x), low(w).t()) + low(b)
        return _bf16(y)

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the precision keeps a layer's activations: float32, or
        bfloat16 below it."""
        return x if self.precision == "fp32" else _bf16(x)

    def batchnorm(self, name: str, x: torch.Tensor, train: bool
                  ) -> torch.Tensor:
        w = self.w
        if train:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = ((flat * flat).mean(dim=0) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                w[f"{name}.running_mean"] = (
                    m * w[f"{name}.running_mean"] + (1 - m) * mean.detach())
                w[f"{name}.running_var"] = (
                    m * w[f"{name}.running_var"] + (1 - m) * var.detach())
        else:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        mul = torch.rsqrt(var + BN_EPS) * w[f"{name}.weight"]
        return self.rounded((x - mean) * mul + w[f"{name}.bias"])

    # -- style encoder ------------------------------------------------------
    def _shared_mlp(self, prefix: str, x: torch.Tensor, n_layers: int,
                    train: bool) -> torch.Tensor:
        for i in range(n_layers):
            x = self.dense(f"{prefix}.linears.{i}", x)
            x = torch.relu(self.batchnorm(f"{prefix}.bns.{i}", x, train))
        return x

    def encode_style(self, cloud: torch.Tensor, fps_starts: torch.Tensor,
                     train: bool = False,
                     dropout_keep: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Style vectors [B, feature_dim] of clouds [B, N, 3]. ``fps_starts``
        [2, B]: the first pick of each set abstraction's FPS. In train mode
        BatchNorm takes the whole batch's statistics and the head's dropout
        keeps ``dropout_keep`` [B, 512]."""
        enc = "style_encoder.encoder"
        xyz, pts = cloud.float(), None
        for layer, (name, npoint, radius, nsample) in enumerate(SA_LAYERS):
            grouped, centers = [], []
            for b in range(xyz.shape[0]):
                pick = geometry.farthest_points(
                    xyz[b], npoint, int(fps_starts[layer, b]))
                c = xyz[b][pick]
                group = geometry.ball_group(xyz[b], c, radius, nsample)
                g = xyz[b][group] - c[:, None, :]
                if pts is not None:
                    g = torch.cat([g, pts[b][group]], dim=-1)
                grouped.append(g)
                centers.append(c)
            h = self._shared_mlp(f"{enc}.{name}", torch.stack(grouped), 3,
                                 train)
            xyz, pts = torch.stack(centers), h.max(dim=2).values
        h = self._shared_mlp(f"{enc}.sa3", torch.cat([xyz, pts], dim=-1), 3,
                             train)
        feat = h.max(dim=1).values
        x = torch.relu(self.dense("style_encoder.fc1", feat))
        if train:
            x = torch.where(dropout_keep, x / KEEP_PROB, torch.zeros_like(x))
        return torch.relu(self.dense("style_encoder.fc2", x))

    # -- denoiser -----------------------------------------------------------
    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        half = self.time_embed_dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32)
                          * -(math.log(10000.0) / (half - 1)))
        args = t.float()[:, None] * freqs.to(t.device)[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)

    def predict_noise(self, x: torch.Tensor, t: torch.Tensor,
                      style: torch.Tensor, train: bool = False,
                      dropout_keep: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
        """Noise [B, N, 3] of points [B, N, 3] at timesteps ``t`` [B] under
        style vectors [B, feature_dim]."""
        p = "noise_predictor"
        h = torch.relu(self.dense(f"{p}.point_encoder.0", x))
        h = torch.relu(self.dense(f"{p}.point_encoder.1", h))
        h = self.dense(f"{p}.point_encoder.2", h)
        t_feat = self.dense(f"{p}.time_proj", self.time_embedding(t))
        s_feat = self.dense(f"{p}.style_proj", style)
        h = self.rounded(self.rounded(h + t_feat[:, None, :])
                         + s_feat[:, None, :])
        for i in range(DENOISER_BLOCKS):
            a = torch.relu(self.dense(f"{p}.blocks.{i}.0", h))
            a = self.dense(f"{p}.blocks.{i}.1", a)
            if train:
                a = torch.where(dropout_keep[i],
                                self.rounded(a / KEEP_PROB),
                                torch.zeros_like(a))
            h = self.rounded(a + h)
        h = torch.relu(self.dense(f"{p}.output_mlp.0", h))
        h = torch.relu(self.dense(f"{p}.output_mlp.1", h))
        return self.dense(f"{p}.output_mlp.2", h)
