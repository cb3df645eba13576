"""PointCloudDiffusionModel: config + the DiffusionNet on one device
(counterpart of ``pointcloud_style_transfer_tpu/models/model.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..device import resolve_device
from ..ops import voxel_downsample
from .networks import DiffusionNet


def dtype_of(config: Config) -> torch.dtype:
    """bf16 compute when ``use_amp`` and ``compute_dtype == "bfloat16"``."""
    return (torch.bfloat16 if config.use_amp
            and config.compute_dtype == "bfloat16" else torch.float32)


class PointCloudDiffusionModel:
    """Bundles the config and its DiffusionNet (eval mode) on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``).
    ``Config.use_pallas`` decides whether FPS and ball query run their CUDA
    kernels or their plain versions."""

    def __init__(self, config: Config, device: str | torch.device | None = None,
                 net: Optional[DiffusionNet] = None):
        self.config = config
        self.device = resolve_device(device)
        if net is None:
            net = DiffusionNet(config.feature_dim, config.time_embed_dim,
                               compute_dtype=dtype_of(config),
                               use_kernels=config.use_pallas)
        self.net = net.to(self.device).eval()

    @torch.no_grad()
    def encode_style(self, cond_points: torch.Tensor,
                     fps_starts: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Style features [B, feature_dim] in the compute dtype."""
        return self.net.encode_style(cond_points, fps_starts, generator)

    @torch.no_grad()
    def predict_noise(self, noisy_points: torch.Tensor, t: torch.Tensor,
                      style_feat: torch.Tensor) -> torch.Tensor:
        return self.net.predict_noise(noisy_points, t, style_feat)

    def forward(self, noisy_points: torch.Tensor, t: torch.Tensor,
                condition_points: torch.Tensor, *,
                cond_drop_prob: float = 0.0, use_hierarchical: bool = True,
                train: bool = False,
                cond_priority: Optional[torch.Tensor] = None,
                noisy_priority: Optional[torch.Tensor] = None,
                fps_starts: Optional[torch.Tensor] = None,
                drop_u: Optional[torch.Tensor] = None,
                style_dropout_mask: Optional[torch.Tensor] = None,
                noise_dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                selections: Optional[dict] = None,
                predict_noise: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[Dict[str, torch.Tensor]]]:
        """The training forward (JAX ``PointCloudDiffusionModel.forward``):
        returns (predicted noise, coarse indices [B, M] | None, the updated
        batch stats by buffer name | None).

        1. voxel-downsample the condition cloud when it has more than
           ``global_points`` (hierarchical);
        2. the style encoder (train mode: batch statistics, dropout; the
           running stats are updated in place);
        3. condition drop: ``keep = u > cond_drop_prob`` zeroes whole style
           rows;
        4. hierarchical and more than ``global_points`` noisy points: predict
           the noise of a voxel downsample and return its indices; else
           predict at full resolution.

        Every draw may be passed in, else it comes from ``generator`` in this
        order: ``cond_priority`` [B, Nc], ``fps_starts`` [2, B],
        ``style_dropout_mask`` [B, 512], ``drop_u`` [B, 1],
        ``noisy_priority`` [B, N], ``noise_dropout_masks`` (one
        [B, M, feature_dim] per residual block). ``selections`` (a dict)
        pins the ReLU gates and max-pool argmaxes the gradient follows
        (``networks.gated_relu``, ``networks.pooled_max``).
        ``predict_noise`` stands in for ``net.predict_noise`` (same
        arguments): the point-sharded step runs it on this rank's rows."""
        M = self.config.global_points
        cond = condition_points
        if use_hierarchical and cond.shape[1] > M:
            cond, _ = voxel_downsample(cond, M, priority=cond_priority,
                                       generator=generator)
        style = self.net.encode_style(cond, fps_starts, generator, train,
                                      style_dropout_mask, selections)
        if cond_drop_prob > 0:
            if drop_u is None:
                drop_u = torch.rand((style.shape[0], 1), generator=generator,
                                    device=style.device)
            keep = drop_u.to(style.device) > cond_drop_prob
            style = style * keep.to(style.dtype)
        idx = None
        if use_hierarchical and noisy_points.shape[1] > M:
            noisy_points, idx = voxel_downsample(
                noisy_points, M, priority=noisy_priority, generator=generator)
        pred = (predict_noise or self.net.predict_noise)(
            noisy_points, t, style, train, noise_dropout_masks, generator,
            selections)
        updates = dict(self.net.named_buffers()) if train else None
        return pred, idx, updates
