from .checkpoint import (load_checkpoint, load_for_inference, save_checkpoint,
                         split_state_dict)

__all__ = ["load_checkpoint", "load_for_inference", "save_checkpoint",
           "split_state_dict"]
