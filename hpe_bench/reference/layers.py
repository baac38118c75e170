"""The plain reference's layers: f32 convolution with bias, BatchNorm, and
the precision a control or a witness computes its convolutions in.

Plain PyTorch, written from the published descriptions; it imports nothing
of the program. Parameter names are the program's (`weight`, `bias`,
`running_mean`, `running_var`), so one set of seeded tensors, keyed by
name, loads into both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0     # largest finite float8_e4m3fn
FP8_GRAD_MAX = 57344.0  # largest finite float8_e5m2
# 'f32': the reference; 'fp8': its control; 'bf16' (the convolutions in
# bf16, their gradients too) and 'f64' (the whole model in float64, which
# the caller casts it to): `calibrate.py`'s witnesses
PRECISIONS = ('f32', 'fp8', 'bf16', 'f64')


def no_tf32() -> None:
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the fp8 `dtype` under one scale for the whole tensor
    (its largest magnitude maps to `top`), and back."""
    s = top / x.abs().amax().clamp_min(1e-30)
    return (x * s).to(dtype).to(x.dtype) / s


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x as an fp8 product reads it: e4m3, one scale a tensor.
    Differentiable straight through."""
    return x + (_round(x.detach(), torch.float8_e4m3fn, FP8_MAX) - x).detach()


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to e5m2
    (one scale a tensor): the gradient an fp8 backward product reads."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_GRAD_MAX)


class Conv(nn.Module):
    """2-D convolution, 'same' padding k // 2, with bias, in f32; under
    `precision='fp8'` as fp8 training computes it: the input and weight
    rounded to e4m3, the gradient arriving at the output to e5m2."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.pad, self.groups = stride, k // 2, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.precision = 'f32'

    def forward(self, x):
        w = self.weight
        if self.precision == 'bf16':
            bf = torch.bfloat16
            return F.conv2d(x.to(bf), w.to(bf), self.bias.to(bf), self.stride, self.pad, 1,
                            self.groups).to(x.dtype)
        if self.precision != 'fp8':
            return F.conv2d(x, w, self.bias, self.stride, self.pad, 1, self.groups)
        y = F.conv2d(fp8(x), fp8(w), self.bias, self.stride, self.pad, 1, self.groups)
        return _Fp8Grad.apply(y)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1, eps 1e-5: the batch's statistics (biased
    variance) in train mode, the running ones in eval mode. The reference
    follows at most three steps and compares no running average, so train
    mode leaves them as they are."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer('running_mean', torch.zeros(n))
        self.register_buffer('running_var', torch.ones(n))

    def forward(self, x, train: bool):
        if train:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, 1e-5)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, 1e-5)


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    """One of PRECISIONS for every convolution."""
    if precision not in PRECISIONS:
        raise ValueError(precision)
    for m in model.modules():
        if isinstance(m, Conv):
            m.precision = precision
    return model
