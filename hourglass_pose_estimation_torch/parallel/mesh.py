"""The data-parallel layout of a process.

Port of `hourglass_pose_estimation_tpu/parallel/mesh.py::make_mesh`. The
JAX package lays a ('data', 'model') mesh over the devices of its
processes; the port runs one process per rank (`torch.distributed`), each
holding one device, a full replica of the state and its contiguous rows of
every global batch, so its layout is this rank's place in the default
process group: the data group.

`batch_sharding` and `replicated_sharding` have no counterpart: each rank
holds its own rows and a full replica, and the collectives are explicit
(DDP's gradient all-reduce, the explicit step's, BatchNorm's statistics).
Tensor parallelism (`model_parallel > 1`, `param_sharding_rules`,
`shard_params`) waits for ROADMAP Queue 1 item 13c.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data group.

    `group` is the data group (the default process group), or None when no
    process group is initialized: then there is one rank and no collective
    runs."""
    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {'data': self.world, 'model': 1}


def make_mesh(data_parallel: int = 0, model_parallel: int = 1, device='cuda') -> Mesh:
    """The data-parallel layout: data_parallel=0 means every rank; any other
    value must equal the world size (1 in a process with no process group).
    `device` is the rank's device: a CUDA device without an index is the
    current one (`multihost.maybe_initialize_distributed` sets it to
    cuda:LOCAL_RANK)."""
    if model_parallel > 1:
        raise NotImplementedError(
            f'model_parallel={model_parallel}: tensor parallelism is not ported yet '
            '(ROADMAP Queue 1 item 13c)')
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data_parallel not in (0, world):
        raise ValueError(
            f'data_parallel={data_parallel} must be 0 (every rank) or the world '
            f'size {world}: the port runs one rank per process (torchrun '
            '--nproc_per_node)')
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return Mesh(world=world, rank=rank, device=dev,
                group=dist.group.WORLD if initialized else None)
