"""Data, pipeline and tensor parallelism over processes
(`torch.distributed`): the port of `hourglass_pose_estimation_tpu/
parallel/`. Names are the JAX package's where one exists; `sync_batch_norm`
is the counterpart of building a model with `bn_axis_name='data'`,
`pipeline` holds the GPipe step over hourglass stacks, and
`tensor_parallel` the layers sharded over conv output channels that XLA's
SPMD partitioner derives from `param_sharding_rules` in the JAX package
(`shard_model`, `gather_params`, `ShardedTrainState`)."""

from hourglass_pose_estimation_torch.models.norm import sync_batch_norm
from hourglass_pose_estimation_torch.parallel.mesh import (
    Mesh, make_mesh, param_sharding_rules, shard_params)
from hourglass_pose_estimation_torch.parallel.multihost import maybe_initialize_distributed
from hourglass_pose_estimation_torch.parallel.shard_map_step import make_shard_map_train_step
from hourglass_pose_estimation_torch.parallel.tensor_parallel import (
    ShardedTrainState, gather_params, shard_model)
