from .checkpoint import (CheckpointManager, load_checkpoint,
                         load_checkpoint_config, load_for_inference,
                         save_checkpoint, split_state_dict)
from .logger import Logger, get_logger

__all__ = ["CheckpointManager", "Logger", "get_logger", "load_checkpoint",
           "load_checkpoint_config", "load_for_inference", "save_checkpoint",
           "split_state_dict"]
