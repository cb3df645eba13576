"""Multi-device paths on ``torch.distributed``: the mesh, the ring kNN and
Chamfer, the data- and point-sharded train/eval steps, the point-sharded and
data-parallel samplers (counterpart of
``pointcloud_style_transfer_tpu/parallel``)."""

from .mesh import (DATA_AXIS, POINTS_AXIS, batch_sharding, make_mesh,
                   replicate, replicated, shard_batch)
from .ring import ring_chamfer_distance, ring_min_sq_dist
from .sharded import make_sharded_eval_step, make_sharded_train_step
from .sharded_sampler import (guided_sample_loop_dp,
                              guided_sample_loop_sharded)

__all__ = [
    "DATA_AXIS", "POINTS_AXIS", "batch_sharding", "make_mesh", "replicate",
    "replicated", "shard_batch", "make_sharded_eval_step",
    "make_sharded_train_step", "ring_chamfer_distance", "ring_min_sq_dist",
    "guided_sample_loop_sharded", "guided_sample_loop_dp",
]
