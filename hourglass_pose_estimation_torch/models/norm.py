"""BatchNorm of the port, with sampled batch statistics (ghost-stat BN).

Port of `hourglass_pose_estimation_tpu/models/norm.py::BatchNorm`: f32
`weight`/`bias` parameters and `running_mean`/`running_var` buffers, the
formula `(x - mean) * (weight * rsqrt(var + eps)) + bias` in at least f32.
The forward takes what its caller applies next: `relu=True` applies the
ReLU, and `out_dtype` casts the result (the next conv's compute dtype);
without them the output is the f32 (or wider) normalisation, as the JAX
BatchNorm's. Eval mode normalises with the running averages. Train mode
normalises with the batch statistics, taken from the first
`stat_samples` samples when 0 < stat_samples < B, and updates the running
averages in place to `momentum * ra + (1 - momentum) * batch` with the
BIASED batch variance. `fast_variance` (the default, flax's) takes the
variance in one pass as max(E[x^2] - E[x]^2, 0); False takes the
two-pass E[(x - mean)^2].

Not `torch.nn.BatchNorm2d`: its running update uses the unbiased
variance, and it has no sampled statistics.

A train-mode forward with the one-pass variance runs the fused
BatchNorm's autograd Function (`ops/hopper/batchnorm.py::batch_norm_train`)
under every row rule below, on any device: on the card its kernels
(statistics, then normalisation with the ReLU and the cast, and two
kernels back), which take a channels-last bf16 or f32 activation with C a
multiple of 8 and raise on any other; on the CPU their plain versions.
Eval mode and the two-pass variance take the plain math.

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
import functools

import torch
import torch.distributed as dist
from torch import nn

from hourglass_pose_estimation_torch.ops.hopper.batchnorm import (
    StatRows, batch_norm_reference, batch_norm_train, running_update_reference)

# the mesh axis BatchNorm statistics sync over: data parallelism
DATA_AXIS = 'data'


def _data_world_size(group) -> int:
    """Ranks of the data group (None: the default process group), 1 when
    there is no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


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

    def forward(self, x: torch.Tensor, train: bool = False, relu: bool = False,
                out_dtype=None) -> torch.Tensor:
        """Normalise x [B, C, H, W] over dim 1, then the ReLU when `relu`, and
        the cast to `out_dtype` when given (else the f32 or wider math's
        dtype)."""
        if not train:
            mean, var = self._running_stats()
            weight, bias = self._affine()
            return batch_norm_reference(x, mean, var, weight, bias, self.eps, relu, out_dtype)
        if self.axis_name is not None and not self.fast_variance:
            raise ValueError('fast_variance=False is a single-shard numerical-parity '
                             'mode; axis_name sync needs the one-pass form')
        rows, mean_form = self._stat_rows(x)
        if self.fast_variance:
            return self._fused(x, rows, mean_form, relu, out_dtype)
        xs = x[:rows.samples].to(torch.promote_types(torch.float32, x.dtype))
        mean = xs.mean(dim=(0, 2, 3))
        var = (xs - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        if self.update_stats:
            self._update_running(mean, var)
        weight, bias = self._affine()
        return batch_norm_reference(x, mean, var, weight, bias, self.eps, relu, out_dtype)

    def _fused(self, x, rows: StatRows, mean_form, relu: bool, out_dtype) -> torch.Tensor:
        """The one-pass train-mode forward through the fused BatchNorm's
        autograd Function; the running averages move in its forward op where
        `_update_running` is BatchNorm's own, else through the override."""
        own = type(self)._update_running is BatchNorm._update_running
        if mean_form is not None:
            rows = rows._replace(sync=functools.partial(_all_reduce, mean=mean_form,
                                                        group=self.group))
        weight, bias = self._affine()
        running = (self.running_mean, self.running_var) if self.update_stats and own else None
        y, mean, var = batch_norm_train(x, weight, bias, rows, running, self.momentum,
                                        self.eps, relu, out_dtype)
        if self.update_stats and not own:
            self._update_running(mean, var)
        return y

    def _affine(self):
        """(scale, bias) over every channel."""
        return self.weight, self.bias

    def _running_stats(self):
        """(running mean, running variance) over every channel."""
        return self.running_mean, self.running_var

    def _stat_rows(self, x: torch.Tensor):
        """The train-mode statistics' rows of x: (StatRows, and whether they
        sync over the data group as a mean of the ranks' moments (True), as
        sums (False), or not at all (None))."""
        k, b = self.stat_samples, x.shape[0]
        hw = x.shape[2] * x.shape[3]
        world = _data_world_size(self.group) if self.axis_name is not None else 1
        if world > 1 and self.global_rows and 0 < k < world * b:
            # the global batch's first k rows: this rank's share of them
            n = min(max(k - dist.get_rank(self.group) * b, 0), b)
            return StatRows(n, 1, k * hw), False
        n = k if 0 < k < b else b
        return StatRows(n, n * hw, 1), (True if world > 1 else None)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        running_update_reference(self.running_mean, self.running_var, mean, var,
                                 self.momentum)


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
