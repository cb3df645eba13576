from .diffusion import (DiffusionSchedule, ddim_step, ddim_timesteps,
                        geometric_constraint, make_beta_schedule,
                        make_schedule, q_sample)
from .model import PointCloudDiffusionModel, dtype_of
from .networks import (DiffusionNet, NoisePredictor, PointNet2Encoder,
                       SetAbstraction, StyleEncoder, time_embedding)
from .transformer import PRESETS, PointETransformer, TransformerSpec
from .samplers import (ddim_sample_loop, guided_sample_loop,
                       guided_sample_loop_coarse,
                       resolve_sampler_knn_backend)

__all__ = [
    "DiffusionSchedule", "make_schedule", "make_beta_schedule", "q_sample",
    "geometric_constraint", "ddim_step", "ddim_timesteps",
    "PointCloudDiffusionModel", "dtype_of", "DiffusionNet", "NoisePredictor",
    "PointNet2Encoder", "SetAbstraction", "StyleEncoder", "time_embedding",
    "guided_sample_loop", "guided_sample_loop_coarse", "ddim_sample_loop",
    "resolve_sampler_knn_backend", "PointETransformer", "TransformerSpec",
    "PRESETS",
]
