"""The (data x pipe) and (data x model) layouts of the ranks, and the
tensor-parallel sharding rule.

Port of `hourglass_pose_estimation_tpu/parallel/mesh.py` (`make_mesh`,
`param_sharding_rules`, `shard_params`) and of the ('data', 'pipe') mesh
the JAX Trainer lays for pipeline parallelism (`runner/trainer.py`,
`devs.reshape(dp, pp)`). The JAX package lays a mesh over the devices of
its processes; the port runs one process per rank (`torch.distributed`),
each holding one device, so its layout is this rank's place in the process
group: rank = d * P + p under pipeline parallelism, rank = d * T + m under
tensor parallelism (the two are not combined), with data coordinate d
(which rows of every global batch it takes), pipe coordinate p (its stage:
which stacks it holds) and model coordinate m (which slice of each sharded
tensor it holds; `parallel/tensor_parallel.py`).

The rule is the JAX one, shape-based, with the dimension read in the torch
layout: a conv weight [cout, cin/groups, kh, kw] whose cout is at least
`min_shard_dim` and divides by the model size shards on dim 0 (its output
channels; JAX's kernel [kh, kw, cin, cout] on its last dim), and so does a
1-D vector (a conv's bias, a BatchNorm's scale, bias and statistics) of
such a length; everything else is replicated. `shard_params` takes this
rank's slices of a standard-layout state_dict (or optimizer tensors);
`tensor_parallel.gather_params`, a collective of the model group, is its
inverse.

`batch_sharding` and `replicated_sharding` have no counterpart: each rank
holds its own rows, and the collectives are explicit (DDP's gradient
all-reduce over the data group, the explicit step's, BatchNorm's
statistics, the pipeline's hand-offs, the sharded layers' gathers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data x pipe) or (data x model) layout.

    `world` and `rank` are the DATA axis: how many ranks split each global
    batch, and this one's coordinate d among them; `pipe` and `stage` are
    the pipe axis, `model` and `model_rank` the model axis. `group` is the
    data group (the ranks of this stage and model coordinate: the default
    process group when pipe and model are 1), `pipe_group` the pipe group
    and `model_group` the model group (the ranks of this data coordinate),
    or None when no process group is initialized (or the axis is 1): then
    no collective of that axis runs."""
    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    pipe: int = 1
    stage: int = 0
    pipe_group: Optional[object] = None
    model: int = 1
    model_rank: int = 0
    model_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {'data': self.world, 'pipe': self.pipe, 'model': self.model}

    @property
    def process_rank(self) -> int:
        """This rank in the process group: d * pipe + p, or d * model + m."""
        return (self.rank * self.pipe + self.stage) * self.model + self.model_rank

    @property
    def size(self) -> int:
        """Every rank of the layout: data x pipe x model."""
        return self.world * self.pipe * self.model


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
    """The layout of data_parallel x pipeline_parallel x model_parallel
    ranks (pipe or model is 1): data_parallel=0 means every rank the other
    axis leaves; they must multiply to the world size (1 in a process with
    no process group). With pipe or model > 1 every rank creates every
    data group (one a pipe or model coordinate) and every pipe or model
    group (one a data coordinate), in one order. `device` is the rank's
    device: a CUDA device without an index is the current one
    (`multihost.maybe_initialize_distributed` sets it to cuda:LOCAL_RANK)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    pp, tp = int(pipeline_parallel), int(model_parallel)
    if pp > 1 and tp > 1:
        raise ValueError(f'pipeline_parallel={pp} with model_parallel={tp}: the layout is '
                         'data x pipe or data x model, not both')
    inner, axis = (pp, 'pipeline_parallel') if pp > 1 else (tp, 'model_parallel')
    if inner > 1 and not initialized:
        raise ValueError(
            f'{axis}={inner} needs {max(data_parallel, 1) * inner} ranks, one a '
            f'{"stage" if pp > 1 else "model shard"} (torchrun --nproc_per_node); this '
            'process has no process group')
    dp = data_parallel or world // inner
    if dp * inner != world:
        raise ValueError(
            f'data_parallel={data_parallel} must be 0 (every rank) or the world '
            f'size {world} over {axis}={inner}: the port runs one rank per '
            'process (torchrun --nproc_per_node)')
    dev = _rank_device(device)
    if inner == 1:
        return Mesh(world=world, rank=rank, device=dev,
                    group=dist.group.WORLD if initialized else None)
    d, q = divmod(rank, inner)
    data_groups = [dist.new_group([e * inner + j for e in range(dp)]) for j in range(inner)]
    inner_groups = [dist.new_group([e * inner + j for j in range(inner)]) for e in range(dp)]
    if pp > 1:
        return Mesh(world=dp, rank=d, device=dev, group=data_groups[q], pipe=pp, stage=q,
                    pipe_group=inner_groups[d])
    return Mesh(world=dp, rank=d, device=dev, group=data_groups[q], model=tp, model_rank=q,
                model_group=inner_groups[d])


def param_sharding_rules(shape, mesh: Mesh, min_shard_dim: int = 128) -> Optional[int]:
    """The dimension of a tensor of (full) `shape` to shard over the model
    axis, or None (replicated): purely shape-based, JAX's rule in the torch
    layout. A conv weight [cout, cin/groups, kh, kw] with cout >=
    min_shard_dim and divisible by the model size shards on its output
    channels, dim 0; a 1-D vector meeting the same test (the bias of such a
    conv, a BatchNorm's scale, bias and statistics) shards on dim 0 too.
    Everything else is replicated."""
    tp = mesh.model
    if tp == 1 or len(shape) not in (1, 4):
        return None
    return 0 if shape[0] >= min_shard_dim and shape[0] % tp == 0 else None


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a standard-layout `state_dict` (any mapping of
    names to tensors: a model's, or an optimizer's per-parameter state) by
    the rule: a sharded tensor's rows [m*n/T, (m+1)*n/T) of dim 0, every
    other tensor as it is (no copy)."""
    out = {}
    for k, t in state_dict.items():
        if isinstance(t, torch.Tensor) and param_sharding_rules(t.shape, mesh) is not None:
            t = t.chunk(mesh.model)[mesh.model_rank]
        out[k] = t
    return out

