"""The (data x pipe) layout of the ranks.

Port of `hourglass_pose_estimation_tpu/parallel/mesh.py::make_mesh` and of
the ('data', 'pipe') mesh the JAX Trainer lays for pipeline parallelism
(`runner/trainer.py`, `devs.reshape(dp, pp)`). The JAX package lays a mesh
over the devices of its processes; the port runs one process per rank
(`torch.distributed`), each holding one device, so its layout is this
rank's place in the process group: rank = d * P + p, data coordinate d
(which rows of every global batch it takes) and pipe coordinate, its
stage, p (which stacks it holds under pipeline parallelism; P = 1
without it). Every rank holds a full replica of what its stage holds.

`batch_sharding` and `replicated_sharding` have no counterpart: each rank
holds its own rows and its replica, and the collectives are explicit
(DDP's gradient all-reduce, the explicit step's, BatchNorm's statistics,
the pipeline's hand-offs). Tensor parallelism (`model_parallel > 1`,
`param_sharding_rules`, `shard_params`) waits for ROADMAP Queue 1 item
13c.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data x pipe) layout.

    `world` and `rank` are the DATA axis: how many ranks split each global
    batch, and this one's coordinate d among them; `pipe` and `stage` are
    the pipe axis. `group` is the data group (the ranks of this stage: the
    default process group when pipe is 1) and `pipe_group` the pipe group
    (the ranks of this data coordinate), or None when no process group is
    initialized: then there is one rank and no collective runs."""
    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    pipe: int = 1
    stage: int = 0
    pipe_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {'data': self.world, 'pipe': self.pipe, 'model': 1}

    @property
    def process_rank(self) -> int:
        """This rank in the process group: d * pipe + p."""
        return self.rank * self.pipe + self.stage

    @property
    def size(self) -> int:
        """Every rank of the layout: data x pipe."""
        return self.world * self.pipe


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def local_mesh(device='cuda') -> Mesh:
    """The layout of this process alone, process group or not (what a
    single-device path such as the standalone evaluator runs on)."""
    return Mesh(world=1, rank=0, device=_rank_device(device))


def make_mesh(data_parallel: int = 0, model_parallel: int = 1, device='cuda',
              pipeline_parallel: int = 1) -> Mesh:
    """The layout of data_parallel x pipeline_parallel ranks:
    data_parallel=0 means every rank the pipe axis leaves; the two must
    multiply to the world size (1 in a process with no process group).
    With pipeline_parallel > 1 every rank creates every data group (one a
    stage) and every pipe group (one a data coordinate), in one order.
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
    pp = int(pipeline_parallel)
    if pp > 1 and not initialized:
        raise ValueError(
            f'pipeline_parallel={pp} needs {max(data_parallel, 1) * pp} ranks, one a '
            'stage (torchrun --nproc_per_node); this process has no process group')
    dp = data_parallel or world // pp
    if dp * pp != world:
        raise ValueError(
            f'data_parallel={data_parallel} must be 0 (every rank) or the world '
            f'size {world} over pipeline_parallel={pp}: the port runs one rank per '
            'process (torchrun --nproc_per_node)')
    dev = _rank_device(device)
    if pp == 1:
        return Mesh(world=world, rank=rank, device=dev,
                    group=dist.group.WORLD if initialized else None)
    d, p = divmod(rank, pp)
    data_groups = [dist.new_group([e * pp + q for e in range(dp)]) for q in range(pp)]
    pipe_groups = [dist.new_group([e * pp + q for q in range(pp)]) for e in range(dp)]
    return Mesh(world=dp, rank=d, device=dev, group=data_groups[p], pipe=pp, stage=p,
                pipe_group=pipe_groups[d])
