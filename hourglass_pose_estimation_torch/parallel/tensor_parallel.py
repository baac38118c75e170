"""Tensor parallelism over conv output channels: sharded storage, gathered
activations.

The JAX package places its parameters by `param_sharding_rules`
(`parallel/mesh.py`) and lets XLA's SPMD partitioner write every
collective; the port runs one process a rank, so it writes them here. On
a (data x model) layout (`make_mesh(dp, tp)`), `shard_model` swaps each
`Conv` and `BatchNorm` of a built model whose tensors the rule shards for
the sharded form, which holds this rank's slice m of them (rows [m*n/T,
(m+1)*n/T) of dim 0):

  * `ShardedConv` computes its slice of the output channels from the FULL
    input (a grouped or depthwise conv from the input channels its groups
    read), in the compute dtype with the bias added after the rounded
    product (`Conv`'s rule), and all-gathers the output over the model
    group. Each output channel is the sum JAX forms, over the same inputs,
    with no reduction split across ranks; so every activation outside a
    conv is full, and the same on every model rank.
  * `ShardedBatchNorm` all-gathers its scale and bias (small vectors) in
    the forward, takes the statistics of the full activation (synced over
    the DATA group, `norm.sync_batch_norm`), and moves only its slice of
    the running statistics; in eval mode it gathers them.

The transposes, each an autograd Function:
  * the output gather's backward is this rank's slice of the incoming
    gradient (that gradient is the same on every model rank, so a
    reduce-scatter would count it T times);
  * a sharded conv's use of its input is an identity forward whose
    backward SUMS the input gradient over the model group (each rank's is
    the part through its own output channels);
  * the BatchNorm parameters' gather takes the slice back, as the output's.
A replicated parameter's gradient is then computed from the same tensors
on every model rank (and averaged over the model group before each step,
`ShardedTrainState`, which keeps it one value and records how far the
ranks' gradients were apart), and DDP over the data group averages every
gradient.

The collectives take the tensors where they lie, on every backend, as
the rest of `parallel/` does (gloo copies a CUDA tensor through host
memory itself). `TRAFFIC` counts the model-axis collectives: calls, the
bytes of their results on this rank, and the host seconds spent in them.

`ShardedTrainState` is a TrainState over a sharded model that keeps a
standard-layout replica: validation runs on the replica with the gathered
parameters and statistics (`standard_model`), and checkpoints are in the
standard layout (`checkpoint_state` gathers the parameters, statistics and
RMSprop accumulators; `restore_state` shards a standard checkpoint again).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hourglass_pose_estimation_torch.models.modules import Conv
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.parallel.mesh import (
    Mesh, param_sharding_rules, shard_params)
from hourglass_pose_estimation_torch.parallel.pipeline import _cpu
from hourglass_pose_estimation_torch.parallel.shard_map_step import all_reduce_
from hourglass_pose_estimation_torch.runner.checkpoint import load_optimizer
from hourglass_pose_estimation_torch.runner.train_state import TrainState


@dataclasses.dataclass
class Traffic:
    """Model-axis collectives of this process: calls, bytes of their
    results on this rank, host seconds."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


TRAFFIC = Traffic()


def _count(nbytes: int, t0: float) -> None:
    TRAFFIC.calls += 1
    TRAFFIC.bytes += nbytes
    TRAFFIC.seconds += time.perf_counter() - t0


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every model rank's `t` concatenated along `dim`, in rank order (no
    autograd)."""
    t0 = time.perf_counter()
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    _count(out.numel() * out.element_size(), t0)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every model rank's `t` (summed in at least f32), in `t`'s
    dtype (no autograd; `t` is left as it is)."""
    t0 = time.perf_counter()
    buf = t.to(torch.promote_types(t.dtype, torch.float32),
               memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(buf, group=group)
    out = buf.to(t.dtype)
    _count(out.numel() * out.element_size(), t0)
    return out


class GatherChannels(torch.autograd.Function):
    """All-gather along `dim` over the model group; the backward is this
    rank's slice of the (model-replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim: int, rank: int):
        ctx.dim, ctx.rank, ctx.size = dim, rank, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


class SumGradOverModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group (the
    input of a sharded conv: each rank's gradient is a partial sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class ShardedConv(nn.Module):
    """This rank's output channels of a `Conv` (weight [cout/T, cin/groups,
    kh, kw], bias [cout/T]), computed from the input channels their groups
    read and gathered over the model group: a drop-in for the conv, full
    input to full output."""

    sharded = True

    def __init__(self, conv: Conv, mesh: Mesh):
        super().__init__()
        T, m = mesh.model, mesh.model_rank
        cout, per_group_in = conv.weight.shape[:2]
        n, per_group_out = cout // T, cout // conv.groups
        if n % per_group_out and per_group_out % n:
            raise ValueError(f'a conv of {conv.groups} groups and {cout} outputs does not '
                             f'split into {T} slices of whole groups')
        g0, g1 = m * n // per_group_out, ((m + 1) * n - 1) // per_group_out
        self.in_channels, self.out_channels = conv.in_channels, cout
        self.in_slice = (g0 * per_group_in, (g1 + 1) * per_group_in) if conv.groups > 1 else None
        self.groups = g1 - g0 + 1
        self.stride, self.padding = conv.stride, conv.padding
        self.compute_dtype = conv.compute_dtype
        self.group, self.rank = mesh.model_group, m
        rows = slice(m * n, (m + 1) * n)
        self.weight = nn.Parameter(conv.weight.detach()[rows].clone())
        self.bias = nn.Parameter(conv.bias.detach()[rows].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = SumGradOverModel.apply(x, self.group)
        if self.in_slice is not None:
            x = x[:, self.in_slice[0]:self.in_slice[1]]
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding, 1,
                     self.groups)
        y = y + self.bias.to(dt)[:, None, None]
        # channels last: the gather concatenates the NHWC view's last dim
        return GatherChannels.apply(y.permute(0, 2, 3, 1), self.group, 3,
                                    self.rank).permute(0, 3, 1, 2)


class ShardedBatchNorm(BatchNorm):
    """This rank's channels of a `BatchNorm`'s scale, bias and running
    statistics; the forward normalises the full activation."""

    sharded = True

    def __init__(self, bn: BatchNorm, mesh: Mesh):
        n = bn.weight.shape[0] // mesh.model
        super().__init__(n, bn.momentum, bn.eps, bn.stat_samples, bn.fast_variance)
        self.update_stats, self.axis_name = bn.update_stats, bn.axis_name
        self.global_rows, self.group = bn.global_rows, bn.group
        self.model_group, self.rank = mesh.model_group, mesh.model_rank
        rows = slice(self.rank * n, (self.rank + 1) * n)
        self.weight = nn.Parameter(bn.weight.detach()[rows].clone())
        self.bias = nn.Parameter(bn.bias.detach()[rows].clone())
        self.running_mean = bn.running_mean[rows].clone()
        self.running_var = bn.running_var[rows].clone()

    def _affine(self):
        both = GatherChannels.apply(torch.stack([self.weight, self.bias]), self.model_group, 1,
                                    self.rank)
        return both[0], both[1]

    def _running_stats(self):
        both = all_gather(torch.stack([self.running_mean, self.running_var]),
                          self.model_group, 1)
        return both[0], both[1]

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        n = self.running_mean.shape[0]
        super()._update_running(mean.narrow(0, self.rank * n, n), var.narrow(0, self.rank * n, n))


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap, in place, each `Conv` and `BatchNorm` under `model` whose weight
    the rule shards (`param_sharding_rules`) for its sharded form holding
    this rank's slice; any architecture, no per-model code. The names, and
    the order of parameters and buffers, stay the standard model's. A
    parent that fuses its children (a bottleneck's `fuse_block`: the
    kernel needs every channel and the whole fold) takes its standard path
    once one of them holds a shard. A model axis of 1 leaves the model as
    it is."""
    if mesh.model == 1:
        return model
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            sharded = {Conv: ShardedConv, BatchNorm: ShardedBatchNorm}.get(type(child))
            if sharded is not None and param_sharding_rules(child.weight.shape, mesh) is not None:
                setattr(parent, name, sharded(child, mesh))
                if hasattr(parent, 'fuse_block'):
                    parent.fuse_block = False
    return model


def gather_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh,
                  shapes: Dict[str, torch.Size]) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_params`: every tensor whose shape is not its
    full one in `shapes` (name -> the standard layout's shape) gathered
    over the model group along dim 0 (one all-gather a dtype), the others
    as they are. A collective of the model group: every rank of it calls
    it with the same names, in one order."""
    out, by_dtype = dict(state_dict), {}
    for k, t in state_dict.items():
        if isinstance(t, torch.Tensor) and tuple(t.shape) != tuple(shapes[k]):
            by_dtype.setdefault(t.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([state_dict[k].reshape(-1) for k in keys])
        ranks = all_gather(flat, mesh.model_group, 0).view(mesh.model, -1)
        offset = 0
        for k in keys:
            t = state_dict[k]
            out[k] = ranks[:, offset:offset + t.numel()].reshape(-1, *t.shape[1:])
            offset += t.numel()
    return out


@dataclasses.dataclass
class ShardedTrainState(TrainState):
    """A TrainState over a tensor-parallel model (`shard_model`), its RMSprop
    accumulators made from the shards (sharded as their parameters, as JAX
    places them), and `standard`, a standard-layout replica of the model
    that validation runs and checkpoints are written from.

    Before each optimizer step the replicated parameters' gradients are
    averaged over the model group (one all-reduce): every model rank
    computes them from the same tensors, but on a card cuDNN may take
    another weight-gradient algorithm in each process (two ranks on one
    card read last-bit differences), and a replicated parameter must stay
    one value on every rank. `replicated_spread` records, for each
    replicated parameter (`replicated`, by name), the largest distance of
    this rank's gradient from that average, relative to the average's
    largest value, the most over the steps so far (0 where the ranks'
    gradients were equal): a transpose that gives the model ranks
    different gradients shows there, not averaged away."""
    mesh: Any = None
    standard: nn.Module = None
    replicated: List[str] = None
    replicated_spread: torch.Tensor = None

    @classmethod
    def create(cls, model: nn.Module, tx, mesh: Mesh) -> 'ShardedTrainState':
        """Shard `model` in place (keeping a standard copy of it first; the
        copy shares the BatchNorms' process groups, which do not copy)."""
        groups = {id(m.group): m.group for m in model.modules()
                  if isinstance(m, BatchNorm) and m.group is not None}
        standard = copy.deepcopy(model, groups)
        shard_model(model, mesh)
        full = dict(standard.named_parameters())
        state = cls(model=model, tx=tx, optimizer=tx.build(list(model.parameters())),
                    mesh=mesh, standard=standard,
                    replicated=[n for n, p in model.named_parameters()
                                if p.shape == full[n].shape])
        state.optimizer.register_step_pre_hook(state._before_step)
        return state

    def _before_step(self, optimizer, args, kwargs) -> None:
        """Average the replicated parameters' gradients over the model
        group, recording how far this rank's were from the average."""
        params = dict(self.model.named_parameters())
        grads = {n: params[n].grad for n in self.replicated if params[n].grad is not None}
        if not grads:
            return
        t0 = time.perf_counter()
        own = {n: g.clone() for n, g in grads.items()}
        all_reduce_(list(grads.values()), self.mesh.model_group, self.mesh.model)
        _count(sum(g.numel() * g.element_size() for g in grads.values()), t0)
        none = next(iter(grads.values())).new_zeros(())
        spread = torch.stack([
            (own[n] - grads[n]).abs().amax() / grads[n].abs().amax().clamp_min(1e-30)
            if n in grads else none for n in self.replicated])
        self.replicated_spread = (spread if self.replicated_spread is None
                                  else torch.maximum(self.replicated_spread, spread))

    def _shapes(self) -> Dict[str, torch.Size]:
        return {k: v.shape for k, v in self.standard.state_dict().items()}

    def standard_state(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict in the standard layout (a collective of
        the model group)."""
        return gather_params(self.model.state_dict(), self.mesh, self._shapes())

    def standard_model(self) -> nn.Module:
        """The replica holding the gathered parameters and statistics (a
        collective of the model group)."""
        self.standard.load_state_dict(self.standard_state())
        return self.standard

    def checkpoint_state(self):
        """(the standard-layout state_dict, the optimizer state with every
        accumulator gathered), on the CPU: a collective of the model
        group."""
        full = [p.shape for p in self.standard.parameters()]
        opt = self.optimizer.state_dict()
        flat = {(i, k): t for i, st in opt['state'].items() for k, t in st.items()}
        shapes = {(i, k): full[i] if isinstance(t, torch.Tensor) and t.dim() else ()
                  for (i, k), t in flat.items()}
        state = {}
        for (i, k), t in _cpu(gather_params(flat, self.mesh, shapes)).items():
            state.setdefault(i, {})[k] = t
        return _cpu(self.standard_state()), dict(opt, state=state)

    def restore_state(self, model: Dict[str, torch.Tensor], optimizer) -> None:
        """Load a standard-layout checkpoint, sharded again; an optimizer
        state of another layout (a pipeline checkpoint's) gives a fresh
        optimizer (`checkpoint.load_optimizer`)."""
        self.model.load_state_dict(shard_params(model, self.mesh))
        saved = None
        if isinstance(optimizer, dict) and 'param_groups' in optimizer:
            saved = dict(optimizer, state={i: shard_params(st, self.mesh)
                                           for i, st in optimizer['state'].items()})
        optimizer = load_optimizer(self.optimizer, saved, self.tx, self.model.parameters())
        if optimizer is not self.optimizer:
            optimizer.register_step_pre_hook(self._before_step)
            self.optimizer = optimizer
