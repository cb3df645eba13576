"""Experiment configuration.

One flat dataclass holding every hyperparameter, field for field the same as
``pointcloud_style_transfer_tpu/config.py``: the defaults are the experiment
spec, checkpoints embed this config, and inference rebuilds the model from it.

Two fields read differently on the GPU:

* ``use_pallas`` — True runs the hand-written CUDA kernels
  (``ops/kernels/``) on CUDA tensors; False runs their plain PyTorch versions
  everywhere, as False selects the jnp paths in the JAX package.
* ``knn_backend`` — ``"auto"`` and ``"grid"`` select the kd-grid (the
  slot-run kernels with the brute-force kernel as exact fallback), as on the
  TPU; ``"pallas"`` the exact brute-force kNN kernel; ``"jnp"`` its plain
  version; ``"pallas_f32packed"`` the f32-packed brute-force kernel (its
  choice can differ between neighbours within about 2^-8 relative distance;
  distances recomputed exactly); ``"pallas_pruned"`` the Morton-pruned exact
  kNN. With ``"auto"`` the sampler also reads the validated
  ``PCST_SAMPLER_KNN_BACKEND`` environment hook (an experiment switch).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class Config:
    # -- experiment bookkeeping --
    experiment_name: str = "train"
    data_root: str = "datasets"
    processed_data_dir: str = os.path.join("datasets", "processed_hierarchical")
    log_dir: str = "logs"
    checkpoint_dir: str = "checkpoints"
    result_dir: str = "results"

    # -- hierarchical data --
    total_points: int = 120000
    global_points: int = 30000

    # -- model --
    time_embed_dim: int = 128
    feature_dim: int = 256
    global_feature_dim: int = 256

    # -- diffusion --
    num_timesteps: int = 1000
    beta_schedule: str = "cosine"
    noise_schedule_offset: float = 0.0008

    # -- training --
    num_epochs: int = 200
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    ema_decay: float = 0.999
    gradient_clip: float = 1.0

    # -- classifier-free guidance --
    cond_drop_prob: float = 0.1
    guidance_scale: float = 7.5

    # -- LR schedule --
    lr_scheduler: str = "cosine_with_warmup"
    warmup_epochs: int = 20
    min_lr_ratio: float = 0.01

    # -- batching --
    batch_size: int = 1
    num_workers: int = 2
    use_amp: bool = True  # selects bf16 compute (compute_dtype below)
    gradient_accumulation_steps: int = 3

    # -- validation / saving --
    val_interval: int = 5
    save_interval: int = 10

    # -- losses --
    loss_scale_factor: float = 1.0
    use_hierarchical: bool = True
    lambda_chamfer: float = 0.1
    chamfer_loss_on_full_points: bool = False

    # -- accelerator additions (same names as the JAX package) --
    seed: int = 42
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # used when use_amp is True
    use_pallas: bool = True  # hand-written kernels on CUDA tensors
    knn_backend: str = "auto"  # auto (= grid) | grid | pallas | jnp
    target_range: float = 1.8  # geometric constraint / normalization range
    use_augmentation: bool = False
    augmentation_rotation_range: float = 0.05
    augmentation_jitter_std: float = 0.005
    augmentation_scale_min: float = 0.98
    augmentation_scale_max: float = 1.02
    content_anchor: float = 0.1

    def make_dirs(self) -> None:
        """Create the output directories (explicit, so that building a
        Config has no side effects)."""
        exp_ckpt = os.path.join(self.checkpoint_dir, self.experiment_name)
        for d in (self.log_dir, self.result_dir, self.processed_data_dir,
                  exp_ckpt):
            os.makedirs(d, exist_ok=True)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
