"""Epoch-granular warmup + cosine LR schedule (counterpart of
``pointcloud_style_transfer_tpu/training/lr_schedule.py``), with its quirks:

* the schedule steps once per EPOCH, not per batch;
* epoch 0 trains at the full base LR (the reference's scheduler only steps
  at the END of an epoch), so the "warmup" goes full -> 1/warmup ->
  2/warmup -> ... -> 1.0 over the first warmup+1 epochs.

Plain Python floats, so the values are the JAX package's to the bit.
"""

from __future__ import annotations

import math


def lr_scale_for_epoch(epoch: int, warmup_epochs: int, total_epochs: int,
                       min_lr_ratio: float = 0.01) -> float:
    """LR multiplier in effect DURING the given 0-indexed epoch."""
    if epoch == 0:
        return 1.0  # reference quirk: no step() has run yet
    if epoch <= warmup_epochs:
        return epoch / warmup_epochs
    progress = (epoch - warmup_epochs) / (total_epochs - warmup_epochs)
    return min_lr_ratio + 0.5 * (1 - min_lr_ratio) * (1 + math.cos(
        math.pi * progress))


def lr_for_epoch(epoch: int, base_lr: float, warmup_epochs: int,
                 total_epochs: int, min_lr_ratio: float = 0.01) -> float:
    return base_lr * lr_scale_for_epoch(epoch, warmup_epochs, total_epochs,
                                        min_lr_ratio)
