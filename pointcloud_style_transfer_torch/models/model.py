"""PointCloudDiffusionModel: config + the DiffusionNet on one device
(counterpart of ``pointcloud_style_transfer_tpu/models/model.py``; the
training forward with condition drop arrives with the trainer)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..device import resolve_device
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
