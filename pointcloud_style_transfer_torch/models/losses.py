"""Training loss: L1 noise loss + Chamfer regulariser (counterpart of
``pointcloud_style_transfer_tpu/models/losses.py``).

total = noise_weight * L1(pred_noise, noise)
      + chamfer_weight * mean_B Chamfer(pred_x0_coarse, x0_coarse)

The terms stay tensors on the device: the trainer sums them over an epoch and
reads them once, so a step never waits for the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops import chamfer_distance


def diffusion_loss(predicted_noise: torch.Tensor, actual_noise: torch.Tensor,
                   predicted_points_coarse: Optional[torch.Tensor] = None,
                   target_points_coarse: Optional[torch.Tensor] = None,
                   noise_weight: float = 1.0, chamfer_weight: float = 0.1,
                   backend: str = "pallas", selections: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"noise_loss", ["chamfer_loss"], "total_loss"}). The L1 is
    taken in float32; the Chamfer's row minima go through ``min_sq_dist``
    with ``backend`` (``"pallas"``: the kernels' custom gradient, whose
    argmins ``selections`` may pin: ``ops.chamfer_distance``)."""
    noise_loss = torch.mean(torch.abs(predicted_noise.float()
                                      - actual_noise.float()))
    total = noise_weight * noise_loss
    loss_dict = {"noise_loss": noise_loss}
    if (chamfer_weight > 0 and predicted_points_coarse is not None
            and target_points_coarse is not None):
        cd = torch.mean(chamfer_distance(predicted_points_coarse,
                                         target_points_coarse, backend,
                                         selections))
        total = total + chamfer_weight * cd
        loss_dict["chamfer_loss"] = cd
    loss_dict["total_loss"] = total
    return total, loss_dict
