"""Networks: time embedding, PointNet++ style encoder, noise predictor
(counterpart of ``pointcloud_style_transfer_tpu/models/networks.py``).

Channels-last throughout, like the JAX package: a 1x1 conv + BN is a
``Dense`` + ``BatchNorm`` over the trailing feature axis. Parameters stay
float32 and each ``Dense`` computes in the module's compute dtype (bf16 when
``Config.use_amp``), as a Flax ``Dense(dtype=bf16)`` with float32 params does;
BatchNorm normalises in float32 and returns the compute dtype.

Train mode is an argument (``train=True``), as in Flax, not the module's
``training`` flag: BatchNorm then normalises with the batch's statistics and
updates its running ones in place, and dropout draws (or is given) its keep
masks. Both follow Flax's arithmetic, which ``nn.BatchNorm1d`` and
``F.dropout`` do not: the biased "fast" variance max(0, E[x^2] - E[x]^2)
stored as is (torch stores the unbiased two-pass one), and ``x / 0.9``
where kept (torch multiplies by 1/0.9, which rounds differently).

Parameter counts at the default widths: style encoder 675,136, noise
predictor 1,874,691, total 2,549,827.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import farthest_point_sample, index_points, query_ball_point


@functools.lru_cache(maxsize=None)
def _frequencies(half: int, device: torch.device) -> torch.Tensor:
    """exp(-log(10000) i / (half - 1)), i < half, computed on the CPU and
    kept on ``device``: every device then embeds a timestep with the same
    bits. (The card's exp differs from the CPU's in the last bit for some
    i, and a timestep of 500 turns that into ~3e-5 in sin and cos.)"""
    freqs = torch.exp(torch.arange(half, dtype=torch.float32)
                      * -(math.log(10000.0) / (half - 1)))
    return freqs.to(device)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] -> [B, dim] float32."""
    freqs = _frequencies(dim // 2, t.device)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's constant)
_TRUNCATED_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in
    ``compute_dtype``, initialised as Flax's ``nn.Dense``: a lecun_normal
    kernel (a normal truncated at two standard deviations, variance
    1 / in_features) and a zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        std = math.sqrt(1.0 / self.in_features) / _TRUNCATED_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


KEEP_PROB = 0.9  # Flax Dropout(0.1)'s keep probability
BN_MOMENTUM = 0.9  # Flax BatchNorm momentum: ra = m * ra + (1 - m) * stat


class BatchNorm(nn.BatchNorm1d):
    """Flax's BatchNorm over the trailing (channel) axis of [..., C]
    (``flax/linen/normalization.py``): in float32, ``(x - mean) *
    (rsqrt(var + 1e-5) * scale) + bias``, returned in ``compute_dtype``.
    ``train=True`` normalises with the batch's mean and biased fast variance
    and updates the running stats in place; otherwise it reads them. With
    ``reduce_stats`` set, the batch is the global one of a data-parallel
    step: its sums are reduced over the ranks before the mean and variance.
    An ``nn.BatchNorm1d`` only for its state-dict names."""

    def __init__(self, num_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=1 - BN_MOMENTUM)
        self.compute_dtype = compute_dtype
        # set by a data-parallel step (parallel/sharded.py): sums a tensor
        # over the ranks that share the batch, gradient included
        self.reduce_stats = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            flat = xf.reshape(-1, x.shape[-1])
            if self.reduce_stats is None:
                mean = flat.mean(dim=0)
                sq = (flat * flat).mean(dim=0)
            else:  # statistics of the global batch: sum x, sum x^2, count
                C = x.shape[-1]
                sums = self.reduce_stats(torch.cat([
                    flat.sum(dim=0), (flat * flat).sum(dim=0),
                    flat.new_full((1,), flat.shape[0])]))
                mean, sq = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


def dropout(x: torch.Tensor, train: bool, keep: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax ``Dropout(0.1)``: in train mode ``where(keep, x / 0.9, 0)``; the
    keep mask (``rand < 0.9``) is drawn from ``generator`` unless given."""
    if not train:
        return x
    if keep is None:
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < KEEP_PROB
    return torch.where(keep.to(x.device), x / KEEP_PROB, torch.zeros_like(x))


def pooled_max(x: torch.Tensor, dim: int, selections: Optional[dict] = None,
               key: str = "pool") -> torch.Tensor:
    """``x.max(dim).values``. With ``selections`` (a dict) the argmax the
    gradient follows is pinned: taken from ``selections[key]`` (the pooled
    input of the step that recorded it; its argmax on its own device) when
    the dict holds it, else ``x`` recorded there."""
    if selections is None:
        return x.max(dim=dim).values
    if key in selections:
        idx = selections[key].max(dim=dim).indices.to(x.device)
        return x.gather(dim, idx.unsqueeze(dim)).squeeze(dim)
    selections[key] = x.detach()
    return x.max(dim=dim).values


def gated_relu(x: torch.Tensor, selections: Optional[dict] = None,
               key: str = "relu") -> torch.Tensor:
    """``F.relu(x)``. With ``selections`` (a dict) the gate the gradient
    follows is pinned: ``x * gate`` with the gate ``selections[key] > 0``
    (the pre-activation of the step that recorded it) when the dict holds
    it, else ``x`` recorded there.

    The pinned selections (these, and the Chamfer's argmins in
    ``ops.distance.MinSqDist``) let a training step on the card follow the
    CPU's discrete choices at near-ties, so that the two differ only by
    continuous rounding; a record holds what each choice was made on, so
    that a choice of another step can be judged against it. Without
    ``selections`` nothing changes."""
    if selections is None:
        return F.relu(x)
    if key in selections:
        return x * (selections[key] > 0).to(x.device, x.dtype)
    selections[key] = x.detach()
    return F.relu(x)


class SetAbstraction(nn.Module):
    """PointNet++ set abstraction: FPS -> ball query -> group (centered) ->
    per-point Dense+BN+ReLU -> max-pool over neighbours. ``group_all`` pools
    every point into one group."""

    def __init__(self, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], in_channels: int, mlp: Sequence[int],
                 group_all: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.use_kernels = use_kernels
        chans = [in_channels, *mlp]
        self.linears = nn.ModuleList(
            Dense(a, b, compute_dtype) for a, b in zip(chans[:-1], chans[1:]))
        self.bns = nn.ModuleList(BatchNorm(c, compute_dtype) for c in mlp)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                fps_start: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, selections: Optional[dict] = None,
                key: str = "sa"):
        """``selections`` pins the ReLU gates and the max-pool's argmaxes
        under ``key``.relu<i> and ``key``.pool (``gated_relu``,
        ``pooled_max``)."""
        B = xyz.shape[0]
        if self.group_all:
            new_xyz = xyz.new_zeros((B, 1, 3))
            grouped = xyz[:, None]
            if points is not None:
                grouped = torch.cat([grouped, points[:, None]], dim=-1)
        else:
            centroid_idx = farthest_point_sample(
                xyz, self.npoint, start=fps_start, generator=generator,
                use_kernel=self.use_kernels)
            new_xyz = index_points(xyz, centroid_idx)  # [B, S, 3]
            group_idx = query_ball_point(self.radius, self.nsample, xyz,
                                         new_xyz, use_kernel=self.use_kernels)
            grouped = index_points(xyz, group_idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([grouped, index_points(points, group_idx)],
                                    dim=-1)
        x = grouped
        for i, (lin, bn) in enumerate(zip(self.linears, self.bns)):
            x = gated_relu(bn(lin(x), train), selections, f"{key}.relu{i}")
        return new_xyz, pooled_max(x, 2, selections, f"{key}.pool")


class PointNet2Encoder(nn.Module):
    """SA(512, r .2, ns 32) -> SA(128, r .4, ns 64) -> SA(group all) ->
    [B, feature_dim]."""

    def __init__(self, feature_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, use_kernels=use_kernels)
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 64, 128), **kw)
        self.sa2 = SetAbstraction(128, 0.4, 64, 3 + 128, (128, 128, 256), **kw)
        self.sa3 = SetAbstraction(None, None, None, 3 + 256,
                                  (256, 512, feature_dim), group_all=True, **kw)

    def forward(self, xyz: torch.Tensor,
                fps_starts: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False,
                selections: Optional[dict] = None) -> torch.Tensor:
        """``fps_starts`` [2, B]: the start indices of the two FPS calls
        (drawn from ``generator`` when not given). ``selections`` pins the
        three set abstractions' gates and argmaxes under ``sa1``, ``sa2``,
        ``sa3``."""
        s1, s2 = (None, None) if fps_starts is None else fps_starts
        l1_xyz, l1_points = self.sa1(xyz, None, s1, generator, train,
                                     selections, "sa1")
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, s2, generator, train,
                                     selections, "sa2")
        _, global_feat = self.sa3(l2_xyz, l2_points, train=train,
                                  selections=selections, key="sa3")
        return global_feat.reshape(xyz.shape[0], -1)


class StyleEncoder(nn.Module):
    """PointNet2Encoder + MLP head -> [B, feature_dim]."""

    def __init__(self, feature_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.encoder = PointNet2Encoder(feature_dim, compute_dtype, use_kernels)
        self.fc1 = Dense(feature_dim, 512, compute_dtype)
        self.fc2 = Dense(512, feature_dim, compute_dtype)

    def forward(self, points: torch.Tensor,
                fps_starts: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False,
                dropout_mask: Optional[torch.Tensor] = None,
                selections: Optional[dict] = None) -> torch.Tensor:
        """``dropout_mask`` [B, 512]: the head's keep mask in train mode;
        ``selections``: the pinned gates and argmaxes (``gated_relu``)."""
        feat = self.encoder(points, fps_starts, generator, train, selections)
        x = dropout(gated_relu(self.fc1(feat), selections, "fc1.relu"), train,
                    dropout_mask, generator)
        return gated_relu(self.fc2(x), selections, "fc2.relu")


class NoisePredictor(nn.Module):
    """Per-point residual MLP denoiser conditioned on time + style (no
    cross-point mixing)."""

    def __init__(self, feature_dim: int = 256, time_embed_dim: int = 128,
                 num_blocks: int = 6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        F_ = feature_dim
        self.time_embed_dim = time_embed_dim
        self.point_encoder = nn.ModuleList([
            Dense(3, 128, compute_dtype), Dense(128, 256, compute_dtype),
            Dense(256, F_, compute_dtype)])
        self.time_proj = Dense(time_embed_dim, F_, compute_dtype)
        self.style_proj = Dense(F_, F_, compute_dtype)
        self.blocks = nn.ModuleList(
            nn.ModuleList([Dense(F_, 2 * F_, compute_dtype),
                           Dense(2 * F_, F_, compute_dtype)])
            for _ in range(num_blocks))
        self.output_mlp = nn.ModuleList([
            Dense(F_, 256, compute_dtype), Dense(256, 128, compute_dtype),
            Dense(128, 3, compute_dtype)])

    def forward(self, noisy_points: torch.Tensor, t: torch.Tensor,
                style_feat: torch.Tensor, train: bool = False,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                selections: Optional[dict] = None) -> torch.Tensor:
        """``dropout_masks``: one [B, N, feature_dim] keep mask per residual
        block in train mode (drawn from ``generator`` when not given);
        ``selections``: the pinned ReLU gates (``gated_relu``)."""
        masks = dropout_masks or [None] * len(self.blocks)
        sel = selections
        pe0, pe1, pe2 = self.point_encoder
        x = gated_relu(pe0(noisy_points), sel, "pe0.relu")
        x = pe2(gated_relu(pe1(x), sel, "pe1.relu"))
        t_feat = self.time_proj(time_embedding(t, self.time_embed_dim))
        s_feat = self.style_proj(style_feat)
        x = x + t_feat[:, None, :] + s_feat[:, None, :]
        for i, ((fc1, fc2), keep) in enumerate(zip(self.blocks, masks)):
            h = gated_relu(fc1(x), sel, f"block{i}.relu")
            x = dropout(fc2(h), train, keep, generator) + x
        o0, o1, o2 = self.output_mlp
        x = gated_relu(o0(x), sel, "out0.relu")
        return o2(gated_relu(o1(x), sel, "out1.relu"))


class DiffusionNet(nn.Module):
    """StyleEncoder + NoisePredictor: the learned parts of the model."""

    def __init__(self, feature_dim: int = 256, time_embed_dim: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.style_encoder = StyleEncoder(feature_dim, compute_dtype,
                                          use_kernels)
        self.noise_predictor = NoisePredictor(feature_dim, time_embed_dim,
                                              compute_dtype=compute_dtype)

    def encode_style(self, cond_points: torch.Tensor,
                     fps_starts: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False,
                     dropout_mask: Optional[torch.Tensor] = None,
                     selections: Optional[dict] = None) -> torch.Tensor:
        return self.style_encoder(cond_points, fps_starts, generator, train,
                                  dropout_mask, selections)

    def predict_noise(self, noisy_points: torch.Tensor, t: torch.Tensor,
                      style_feat: torch.Tensor, train: bool = False,
                      dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      selections: Optional[dict] = None) -> torch.Tensor:
        return self.noise_predictor(noisy_points, t, style_feat, train,
                                    dropout_masks, generator, selections)
