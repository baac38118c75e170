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
variance, and it has no sampled statistics. Cross-device statistics
(`axis_name`) come with the parallel slice.

`update_stats = False` (see `running_stats_frozen`) keeps the running
averages as they are in train mode: a rematerialised forward recomputes
the batch statistics for its backward without moving the averages a
second time, as the JAX package's functional remat does.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        sdt = torch.promote_types(torch.float32, x.dtype)
        shape = (1, -1, 1, 1)
        if train:
            k = self.stat_samples
            xs = (x[:k] if 0 < k < x.shape[0] else x).to(sdt)
            axes = (0, 2, 3)
            mean = xs.mean(dim=axes)
            if self.fast_variance:
                var = torch.clamp_min(xs.square().mean(dim=axes) - mean.square(), 0.0)
            else:
                var = (xs - mean.view(shape)).square().mean(dim=axes)
            if self.update_stats:
                self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight.to(sdt) * torch.rsqrt(var.to(sdt) + self.eps)
        return ((x.to(sdt) - mean.to(sdt).view(shape))
                * mul.view(shape) + self.bias.to(sdt).view(shape))

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
