"""Training: the train/eval steps, the optimizer chain, EMA, the LR
schedule and the trainer (counterpart of
``pointcloud_style_transfer_tpu/training``)."""

from .ema import call_with_params, ema_init, ema_update
from .lr_schedule import lr_for_epoch, lr_scale_for_epoch
from .optimizer import MultiStepsAdamW
from .trainer import (DiffusionTrainer, compute_losses, eval_step,
                      make_optimizer, train_step)

__all__ = ["DiffusionTrainer", "MultiStepsAdamW", "call_with_params",
           "compute_losses", "ema_init", "ema_update", "eval_step",
           "lr_for_epoch", "lr_scale_for_epoch", "make_optimizer",
           "train_step"]
