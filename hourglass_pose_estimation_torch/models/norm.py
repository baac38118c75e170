"""BatchNorm of the port, with sampled batch statistics (ghost-stat BN).

Port of `hourglass_pose_estimation_tpu/models/norm.py::BatchNorm`: f32
`weight`/`bias` parameters and `running_mean`/`running_var` buffers, the
formula `(x - mean) * (weight * rsqrt(var + eps)) + bias` in at least f32,
and an f32 (or wider) output that the next conv casts to its compute
dtype. Eval mode normalises with the running averages. Train mode
normalises with the batch statistics, taken from the first
`stat_samples` samples when 0 < stat_samples < B, and updates the running
averages in place to `momentum * ra + (1 - momentum) * batch` with the
BIASED batch variance. `fast_variance` (the default, flax's) takes the
variance in one pass as max(E[x^2] - E[x]^2, 0); False takes the
two-pass E[(x - mean)^2].

Not `torch.nn.BatchNorm2d`: its running update uses the unbiased
variance, and it has no sampled statistics.

Cross-rank statistics (`axis_name='data'`, set on a built model by
`sync_batch_norm`; flax's `axis_name`): a train-mode forward averages the
one-pass (mean, E[x^2]) over the data group (`group`: the mesh's data
group, `parallel.make_mesh`'s `Mesh.group`, or None for the default
process group when every rank is a data rank) before it forms the
variance, as `jax.lax.pmean` does in the JAX BatchNorm, so every rank
normalises with, and moves its running averages by, the global batch's
statistics. The average is differentiable: its backward is the transpose
of a pmean, a SUM all-reduce of the cotangents divided by the world size.
With `stat_samples=k` the rows follow the path (`sync_batch_norm`'s
`global_rows`, which the Trainer sets per path): on the explicit
(shard_map) path each rank takes its own first k samples before the
average, as each JAX shard slices its own; on the implicit (jit) path the
statistics are the GLOBAL batch's first k samples, as JAX's `x[:k]` on a
batch that jit shards: data coordinate r (its rank in the data group; b
rows) contributes its rows
[0, clamp(k - r*b, 0, b)), and the sums (sum x, sum x^2) of every rank's
rows, all-reduced, are divided by k (the same differentiable all-reduce,
in its sum form; a rank with no rows in the first k contributes zeros and
still issues it, so every rank issues the same collectives in the same
order, a remat's recomputation included). Under tensor parallelism every
model rank of a data coordinate holds the same rows, so the data group,
not the process group, is what a sum may count once. At a data group of
one rank, or with no process group, the forward is the unsynced one. Eval
mode never communicates.

The forward reads its affine parameters and running statistics through
`_affine` and `_running_stats` and moves the statistics through
`_update_running`, which a sharded BatchNorm
(`parallel/tensor_parallel.py`) overrides.

`update_stats = False` (see `running_stats_frozen`) keeps the running
averages as they are in train mode: a rematerialised forward recomputes
the batch statistics for its backward without moving the averages a
second time, as the JAX package's functional remat does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

# the mesh axis BatchNorm statistics sync over: data parallelism
DATA_AXIS = 'data'


def _data_world_size(group) -> int:
    """Ranks of the data group (None: the default process group), 1 when
    there is no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


class _MeanOverRanks(torch.autograd.Function):
    """pmean over the data group: SUM all-reduce / world, and the same in
    the backward (the transpose of a pmean). `mean=False` is the sum form,
    psum, whose transpose is a psum too."""

    @staticmethod
    def forward(ctx, x, mean: bool = True, group=None):
        ctx.mean, ctx.group = mean, group
        return _all_reduce(x, mean, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mean, ctx.group), None, None


def _all_reduce(x: torch.Tensor, mean: bool, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group) if mean else y


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over dim 1 of an NCHW tensor (any memory
    format)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, stat_samples: int = 0,
                 fast_variance: bool = True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.stat_samples = stat_samples
        self.fast_variance = fast_variance
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.update_stats = True
        self.axis_name = None
        self.global_rows = False
        self.group = None

    def set_axis_name(self, axis_name) -> None:
        """Sync the train-mode statistics over `axis_name` ('data'), or not
        (None)."""
        if axis_name not in (None, DATA_AXIS):
            raise ValueError(f'axis_name={axis_name!r}: the port has one mesh axis, '
                             f'{DATA_AXIS!r} (data parallelism)')
        self.axis_name = axis_name

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        sdt = torch.promote_types(torch.float32, x.dtype)
        shape = (1, -1, 1, 1)
        if train:
            mean, var = self._batch_stats(x, sdt)
            if self.update_stats:
                self._update_running(mean, var)
        else:
            mean, var = self._running_stats()
        weight, bias = self._affine()
        mul = weight.to(sdt) * torch.rsqrt(var.to(sdt) + self.eps)
        return ((x.to(sdt) - mean.to(sdt).view(shape))
                * mul.view(shape) + bias.to(sdt).view(shape))

    def _affine(self):
        """(scale, bias) over every channel."""
        return self.weight, self.bias

    def _running_stats(self):
        """(running mean, running variance) over every channel."""
        return self.running_mean, self.running_var

    def _batch_stats(self, x: torch.Tensor, sdt):
        """(mean, biased variance) of the train-mode statistics' rows."""
        k, axes = self.stat_samples, (0, 2, 3)
        if self.axis_name is not None and not self.fast_variance:
            raise ValueError('fast_variance=False is a single-shard numerical-parity '
                             'mode; axis_name sync needs the one-pass form')
        world = _data_world_size(self.group) if self.axis_name is not None else 1
        if world == 1:
            xs = (x[:k] if 0 < k < x.shape[0] else x).to(sdt)
            mean = xs.mean(dim=axes)
            if self.fast_variance:
                return mean, torch.clamp_min(xs.square().mean(dim=axes) - mean.square(), 0.0)
            return mean, (xs - mean.view(1, -1, 1, 1)).square().mean(dim=axes)
        b = x.shape[0]
        if self.global_rows and 0 < k < world * b:
            # the global batch's first k rows: this rank's share of them
            n = min(max(k - dist.get_rank(self.group) * b, 0), b)
            xs = x[:n].to(sdt)
            sums = torch.stack([xs.sum(dim=axes), xs.square().sum(dim=axes)])
            mean, mean2 = (_MeanOverRanks.apply(sums, False, self.group)
                           / (k * x.shape[2] * x.shape[3]))
        else:
            xs = (x[:k] if 0 < k < b else x).to(sdt)
            mean, mean2 = _MeanOverRanks.apply(
                torch.stack([xs.mean(dim=axes), xs.square().mean(dim=axes)]), True, self.group)
        return mean, torch.clamp_min(mean2 - mean.square(), 0.0)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module, frozen: bool = True):
    """Within the block, train-mode BatchNorms under `module` leave their
    running averages as they are (when `frozen`)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    try:
        for m in bns:
            m.update_stats = m.update_stats and not frozen
        yield
    finally:
        for m, v in zip(bns, saved):
            m.update_stats = v


def sync_batch_norm(module: nn.Module, axis_name=DATA_AXIS,
                    global_rows: bool = False, group=None) -> nn.Module:
    """Set `axis_name` on every BatchNorm under `module` (None: no sync):
    the one switch of global-batch statistics that both data-parallel
    paths and `hg(bn_axis_name=...)` use, for any architecture.
    `global_rows` picks the rows of sampled statistics (`stat_samples`):
    the global batch's first k (the implicit path's, JAX's jit) or each
    rank's first k (False, the explicit path's, JAX's shard_map). `group`
    is the data group to sync over (the mesh's `group`; None: the default
    process group)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.set_axis_name(axis_name)
            m.global_rows = global_rows
            m.group = group
    return module
