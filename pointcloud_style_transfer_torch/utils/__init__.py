from .checkpoint import (CheckpointManager, load_checkpoint, load_for_inference,
                         save_checkpoint, split_state_dict)
from .logger import get_logger

__all__ = ["CheckpointManager", "get_logger", "load_checkpoint",
           "load_for_inference", "save_checkpoint", "split_state_dict"]
