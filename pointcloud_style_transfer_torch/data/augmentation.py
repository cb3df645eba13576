"""Point-cloud augmentation (counterpart of
``pointcloud_style_transfer_tpu/data/augmentation.py``): a random Z rotation
within +-rotation_range radians, gaussian jitter, a uniform isotropic scale,
then an optional point-order shuffle, each per cloud of a batch.

Every draw can be passed in as a tensor, so that a test can give both
packages the same numbers: ``angles`` [B] (radians), ``jitter`` [B, N, 3]
(standard normal; multiplied by ``jitter_std`` here), ``scales`` [B] and
``perms`` [B, N]. The others come from ``generator``, in that order, and
only for the steps that run.
"""

from __future__ import annotations

from typing import Optional

import torch


def augment_points(points: torch.Tensor, rotation_range: float = 0.05,
                   jitter_std: float = 0.005, scale_min: float = 0.98,
                   scale_max: float = 1.02, shuffle: bool = False, *,
                   angles: Optional[torch.Tensor] = None,
                   jitter: Optional[torch.Tensor] = None,
                   scales: Optional[torch.Tensor] = None,
                   perms: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Rotation -> jitter -> scale (-> shuffle) of [B, N, 3]."""
    B, N, _ = points.shape
    dev = points.device
    x = points

    def drawn(given, draw):
        return draw() if given is None else given.to(dev)

    if rotation_range > 0:
        ang = drawn(angles, lambda: (torch.rand(
            (B,), generator=generator, device=dev) * 2 - 1) * rotation_range)
        c = torch.cos(ang).to(x.dtype)[:, None]
        s = torch.sin(ang).to(x.dtype)[:, None]
        # x @ R with R = [[c, -s, 0], [s, c, 0], [0, 0, 1]] per cloud, each
        # product and sum rounded on its own
        x0, x1 = x[..., 0], x[..., 1]
        x = torch.stack([x0 * c + x1 * s, x1 * c - x0 * s, x[..., 2]], -1)

    if jitter_std > 0:
        x = x + drawn(jitter, lambda: torch.randn(
            x.shape, generator=generator, device=dev)) * jitter_std

    if not (scale_min == 1.0 and scale_max == 1.0):
        scale = drawn(scales, lambda: scale_min + torch.rand(
            (B,), generator=generator, device=dev) * (scale_max - scale_min))
        x = x * scale.reshape(B, 1, 1).to(x.dtype)

    if shuffle:
        perm = drawn(perms, lambda: torch.stack([
            torch.randperm(N, generator=generator, device=dev)
            for _ in range(B)]))
        x = torch.gather(x, 1, perm.long()[..., None].expand(-1, -1, 3))
    return x
