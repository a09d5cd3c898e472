"""Parallel axes over ``torch.distributed``: the process mesh, batched
filter instances (a lane axis on one device) and the landmark-sharded
update."""

from .batch import batch_sim_step, make_batched_states
from .landmark_shard import sharded_vision_update
from .mesh import gather_batch, init_distributed, make_mesh, shard_batch

__all__ = ["batch_sim_step", "gather_batch", "init_distributed", "make_batched_states", "make_mesh", "shard_batch",
           "sharded_vision_update"]
