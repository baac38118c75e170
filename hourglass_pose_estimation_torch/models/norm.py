"""BatchNorm of the port (eval mode in this slice).

Port of `hourglass_pose_estimation_tpu/models/norm.py::BatchNorm`: f32
`weight`/`bias` parameters and `running_mean`/`running_var` buffers,
the same eval formula `(x - mean) * (weight * rsqrt(var + eps)) + bias`
in at least f32, and an f32 (or wider) output that the next conv casts
to its compute dtype. Not `torch.nn.BatchNorm2d`: its running update uses
the unbiased variance, where the JAX package's uses the biased one, and
training will need this module's own update anyway.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over dim 1 of an NCHW tensor (any memory
    format)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(
                'train-mode BatchNorm (batch statistics and the running '
                'update) comes with the training slice: ROADMAP Queue 1 '
                'item 2')
        sdt = torch.promote_types(torch.float32, x.dtype)
        shape = (1, -1, 1, 1)
        mul = self.weight.to(sdt) * torch.rsqrt(self.running_var.to(sdt) + self.eps)
        return ((x.to(sdt) - self.running_mean.to(sdt).view(shape))
                * mul.view(shape) + self.bias.to(sdt).view(shape))
