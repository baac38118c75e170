"""The explicit-collectives data-parallel train step.

Port of `hourglass_pose_estimation_tpu/parallel/shard_map_step.py::
make_shard_map_train_step`. The implicit path (`runner.train_state.
make_train_step` with a mesh: DDP) leaves the gradient all-reduce to
DistributedDataParallel; this step spells the collectives out, as the JAX
shard_map step does with `psum`: each rank augments and steps its own rows
with its own augmentation stream (the step generator with the rank folded
in, `fold_in(rng, axis_index)` then the step in JAX), runs its forward and
backward, and ONE all-reduce averages the gradients (and, with `sync_bn`,
the running BatchNorm statistics) before every rank applies the same
RMSprop update. The loss is the mean over the ranks; PCK comes from the
hit and valid counts summed over the ranks before they are combined.

`sync_bn=True` with a model whose BatchNorms sync their statistics in the
forward (`norm.sync_batch_norm`, which the Trainer sets for
TRAIN.explicit_collectives with TRAIN.sync_bn) gives global-batch
statistics, and the running averages' all-reduce is then a numeric no-op.
`sync_bn=False` keeps torch DataParallel's per-replica statistics in the
forward, and each rank keeps its own running averages: the JAX step
returns them under `out_specs=P()` with `check_rep=False`, which leaves
each device its own copy, and what a JAX user reads back (a checkpoint,
`np.asarray`) is the first shard's, rank 0's here (the Trainer's
checkpoints are rank 0's). The state must start replicated (the Trainer
builds it from COMMON.seed on every rank); the batch is always the device
pipeline's canvases.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch.data.pipeline import (
    augment_batch, sample_augmentations, to_device)
from hourglass_pose_estimation_torch.loss import heatmap_mse_loss
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.runner.train_state import (
    TrainState, _device_of, _select_subset, step_generator, step_metrics)


def all_reduce_(tensors: List[torch.Tensor], group, divide: int) -> None:
    """Replace each tensor by its sum over `group` (None: every rank) /
    `divide`, in ONE all-reduce of their concatenation (in the first
    tensor's dtype)."""
    flat = torch.cat([t.reshape(-1).to(tensors[0].dtype) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= divide
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def mean_over_ranks_(tensors: List[torch.Tensor], mesh) -> None:
    """Replace each tensor (one dtype) by its mean over the mesh's data
    ranks, in ONE all-reduce; nothing without a process group."""
    if mesh.group is not None and tensors:
        all_reduce_(tensors, mesh.group, mesh.world)


def make_shard_map_train_step(spec, mesh, *, subset=None, pck_thr: float = 0.5,
                              sync_bn: bool = True):
    """The explicit step over `mesh` (`parallel.make_mesh`):
    (state, raw_batch, rng) -> (state, metrics), as `make_train_step`'s
    device-pipeline step; raw_batch is this rank's rows."""
    subset_t = tuple(subset) if subset is not None else None

    def train_step(state: TrainState, batch, rng):
        dev = _device_of(state)
        data = to_device(batch, dev)
        draws = sample_augmentations(
            step_generator(rng, state.step, dev, rank=mesh.rank), data['scale'],
            scale_factor=spec.scale_factor, rot_factor=spec.rot_factor, train=True)
        data = augment_batch(data, draws, spec, True)
        target, tw = _select_subset(data['target'], data['target_weight'], subset_t)
        outs = state.model(data['image'], train=True)
        loss = heatmap_mse_loss(outs, target, tw)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            shared = [p.grad for p in state.model.parameters()]
            if sync_bn:
                shared += [t for m in state.model.modules() if isinstance(m, BatchNorm)
                           for t in (m.running_mean, m.running_var)]
            mean_over_ranks_(shared, mesh)
            metrics = step_metrics(loss, outs[-1], target, pck_thr, mesh)
        for group in state.optimizer.param_groups:
            group['lr'] = state.tx.lr(state.step)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step
