"""Data and pipeline parallelism over processes (`torch.distributed`): the
port of `hourglass_pose_estimation_tpu/parallel/` less tensor parallelism
(`param_sharding_rules`, `shard_params`, ROADMAP Queue 1 item 13c). Names
are the JAX package's where one exists; `sync_batch_norm` is the
counterpart of building a model with `bn_axis_name='data'`, and
`pipeline` holds the GPipe step over hourglass stacks."""

from hourglass_pose_estimation_torch.models.norm import sync_batch_norm
from hourglass_pose_estimation_torch.parallel.mesh import Mesh, make_mesh
from hourglass_pose_estimation_torch.parallel.multihost import maybe_initialize_distributed
from hourglass_pose_estimation_torch.parallel.shard_map_step import make_shard_map_train_step
