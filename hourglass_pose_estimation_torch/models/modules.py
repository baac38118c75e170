"""Building blocks: pre-activation bottleneck and the hourglass module.

Port of `hourglass_pose_estimation_tpu/models/modules.py` (train and eval
forwards).
Tensors are NCHW-shaped in `torch.channels_last` memory format, so the
physical layout is NHWC: the Hopper kernels read it as it is (through a
permuted view) and cuDNN's channels-last convolutions use it too.
Parameters are f32; convolutions compute in `dtype` (bf16 by default);
BatchNorm math is f32, and a BatchNorm ahead of a conv applies the ReLU
and writes the conv's dtype itself. Submodules are named after the flax
paths (`up1_l4.block0.bn1`, ...), which is what `weights.py` relies on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.ops.hopper import (
    BottleneckParams, fused_bottleneck, maxpool2x2, params_from_variables,
    upsample2x_add)
from hourglass_pose_estimation_torch.ops.hopper.bottleneck import PLANES
from hourglass_pose_estimation_torch.ops.hopper.upsample import (
    upsample2x_nearest as _upsample2x_nhwc)

EXPANSION = 2


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of an NCHW tensor (the result
    is channels-last)."""
    return _upsample2x_nhwc(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def max_pool(x: torch.Tensor, kernel: bool) -> torch.Tensor:
    """2x2 stride-2 max-pool of an NCHW (channels-last) tensor: through the
    pool kernel's differentiable wrapper (`ops/hopper/pool.py`) when
    `kernel`, else `F.max_pool2d`. Both give a window's gradient to its
    first maximum, as the JAX package's `nn.max_pool` does."""
    if not kernel:
        return F.max_pool2d(x, 2, 2)
    return maxpool2x2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Conv(nn.Conv2d):
    """`flax.linen.Conv` as the JAX models use it: f32 parameters, the
    product computed in `dtype`, 'same' padding k // 2, bias. As in flax,
    the bias is added to the product after it is rounded to `dtype`: in
    bf16 that is a second rounding. `F.conv2d` given the bias takes it
    into the product's sum on the CPU (oneDNN), which leaves 30% of a bf16
    conv's outputs one bf16 step away; on the card it adds the bias after
    the product, as here."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 groups: int = 1, dtype=torch.bfloat16):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=k // 2,
                         groups=groups, bias=True)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None,
                     self.stride, self.padding, 1, self.groups)
        return y + self.bias.to(dt)[:, None, None]


class Bottleneck(nn.Module):
    """Pre-activation residual bottleneck, expansion 2.

    `mobile=True` makes the 3x3 depthwise. A 1x1-conv shortcut
    (`downsample`) is added iff stride != 1 or in_ch != 2*planes.
    `fuse_block` runs a running-average-BN forward (eval, serving, the
    frozen-BN train step) of an identity-residual, stride-1, non-mobile
    block of at least `fuse_min_hw` pixels a side as the fused bottleneck
    (ops/hopper/bottleneck.py), differentiable through its autograd
    Function, where the block is in the kernel's scope: bf16 compute and
    PLANES planes. Every other block takes the standard path: the JAX
    package's gating, narrowed to what the kernel takes."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 mobile: bool = False, dtype=torch.bfloat16,
                 fuse_block: bool = False, fuse_min_hw: int = 16):
        super().__init__()
        c_out = planes * EXPANSION
        self.planes, self.stride, self.mobile = planes, stride, mobile
        self.compute_dtype = dtype
        self.fuse_block, self.fuse_min_hw = fuse_block, fuse_min_hw
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = Conv(in_ch, planes, 1, dtype=dtype)
        self.bn2 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride,
                          groups=planes if mobile else 1, dtype=dtype)
        self.bn3 = BatchNorm(planes)
        self.conv3 = Conv(planes, c_out, 1, dtype=dtype)
        self.downsample = (Conv(in_ch, c_out, 1, stride, dtype=dtype)
                           if stride != 1 or in_ch != c_out else None)
        self._fold_cache = None
        self.fold_frozen = False

    _FOLDED = ('bn1', 'bn2', 'bn3', 'conv1', 'conv2', 'conv3')

    def fused_params(self) -> BottleneckParams:
        """This block's folded parameters for the fused kernel (through the
        JAX-layout `params_from_variables`: conv weights OIHW -> HWIO
        views), differentiable in the live parameters."""
        bn = lambda m: {'scale': m.weight, 'bias': m.bias}
        conv = lambda m: {'kernel': m.weight.permute(2, 3, 1, 0), 'bias': m.bias}
        stats = lambda m: {'mean': m.running_mean, 'var': m.running_var}
        names = self._FOLDED
        return params_from_variables(
            {'params': {n: (bn if n.startswith('bn') else conv)(getattr(self, n))
                        for n in names},
             'batch_stats': {n: stats(getattr(self, n)) for n in names[:3]}},
            eps=self.bn1.eps, dtype=self.compute_dtype)

    def freeze_fold(self) -> None:
        """Make the fold once, now, and keep it as non-persistent buffers
        (`fold_a1` ... `fold_c3`) that the fused forward reads as they are:
        for an inference module whose weights no longer change
        (`export.InferenceModule`), where it costs no call any fold work and
        `torch.export` reads the folds as constants. A frozen block refuses
        to train (a train-mode forward, or one that autograd records): its
        fold would not follow the weights."""
        with torch.no_grad():
            fold = self.fused_params()
        for name, t in fold._asdict().items():
            # a copy: a leaf of the fold may be a view of a parameter
            self.register_buffer(f'fold_{name}', t.detach().clone(), persistent=False)
        self.fold_frozen = True

    def _folded(self) -> BottleneckParams:
        """The fold for this forward: the frozen one (`freeze_fold`) where
        there is one. Else, where autograd records, it is made from the
        live parameters each call (the frozen-BN train step differentiates
        through it); otherwise it is cached and made again when any source
        tensor was replaced or changed in place (an optimizer step or a
        running-statistics update bumps its version)."""
        if self.fold_frozen:
            return BottleneckParams(*(getattr(self, f'fold_{n}')
                                      for n in BottleneckParams._fields))
        if torch.is_grad_enabled():
            return self.fused_params()
        srcs = [t for n in self._FOLDED
                for t in getattr(self, n).parameters(recurse=False)]
        srcs += [getattr(self, n).running_mean for n in self._FOLDED[:3]]
        srcs += [getattr(self, n).running_var for n in self._FOLDED[:3]]
        key = tuple((t.data_ptr(), t.dtype, t._version) for t in srcs)
        if self._fold_cache is None or self._fold_cache[0] != key:
            with torch.no_grad():
                self._fold_cache = (key, self.fused_params())
        return self._fold_cache[1]

    def fusable(self) -> bool:
        """The JAX package's gating, narrowed to the kernel's scope (bf16
        compute and PLANES planes: an f32 or narrower block runs the
        standard path on every device), less what depends on the forward:
        an identity-residual, stride-1, non-mobile block with
        `fuse_block` on."""
        return (self.fuse_block and self.stride == 1 and self.downsample is None
                and self.compute_dtype == torch.bfloat16 and self.planes == PLANES
                and not self.mobile)

    def _fuses(self, x: torch.Tensor, train: bool) -> bool:
        return (not train and self.fusable()
                and min(x.shape[2], x.shape[3]) >= self.fuse_min_hw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.fold_frozen and (train or torch.is_grad_enabled()):
            raise RuntimeError('Bottleneck: its fold is frozen for inference '
                               '(freeze_fold); trained, it would read a stale fold')
        if self._fuses(x, train):
            y = fused_bottleneck(x.to(self.compute_dtype).permute(0, 2, 3, 1),
                                 self._folded())
            return y.permute(0, 3, 1, 2)
        dt = self.compute_dtype
        out = self.conv1(self.bn1(x, train, relu=True, out_dtype=dt))
        out = self.conv2(self.bn2(out, train, relu=True, out_dtype=dt))
        out = self.conv3(self.bn3(out, train, relu=True, out_dtype=dt))
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual.to(out.dtype)


class ResidualChain(nn.Module):
    """`num_blocks` bottlenecks on 2*planes channels (`block0`, ...)."""

    def __init__(self, planes: int, num_blocks: int = 1, mobile: bool = False,
                 dtype=torch.bfloat16, fuse_block: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'block{i}', Bottleneck(
                planes * EXPANSION, planes, mobile=mobile, dtype=dtype,
                fuse_block=fuse_block))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f'block{i}')(x, train)
        return x


class Hourglass(nn.Module):
    """Depth-`depth` encoder-decoder at constant width 2*planes, written
    as an encoder loop, a bottom chain and a decoder loop. Merges are
    `sum` or `concat` with one shared grouped 1x1 conv, as in the JAX
    package. `fuse_upsample` routes the sum merges through the fused
    upsample+add and the encoder pools through the pool kernel (each a
    differentiable wrapper of its forward and backward kernels)."""

    def __init__(self, planes: int, depth: int = 4, num_blocks: int = 1,
                 mobile: bool = False, skip_mode: str = 'sum',
                 dtype=torch.bfloat16, fuse_upsample: bool = False,
                 fuse_block: bool = False):
        super().__init__()
        if skip_mode not in ('sum', 'concat'):
            raise ValueError(f"skip_mode must be 'sum' or 'concat', got {skip_mode!r}")
        self.depth, self.skip_mode = depth, skip_mode
        self.fuse_upsample = fuse_upsample
        chain = lambda: ResidualChain(planes, num_blocks, mobile, dtype,
                                      fuse_block=fuse_block)
        for n in range(depth, 0, -1):
            self.add_module(f'up1_l{n}', chain())
            self.add_module(f'low1_l{n}', chain())
        self.low2_l1 = chain()
        for n in range(1, depth + 1):
            self.add_module(f'low3_l{n}', chain())
        self.concat_conv = (Conv(planes * EXPANSION * 2, planes * EXPANSION, 1,
                                 groups=2, dtype=dtype)
                            if skip_mode == 'concat' else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        skips = []
        for n in range(self.depth, 0, -1):
            skips.append(getattr(self, f'up1_l{n}')(x, train))
            x = max_pool(x, self.fuse_upsample)
            x = getattr(self, f'low1_l{n}')(x, train)
        x = self.low2_l1(x, train)
        for n in range(1, self.depth + 1):
            x = getattr(self, f'low3_l{n}')(x, train)
            up1 = skips.pop()
            if self.skip_mode == 'concat':
                x = self.concat_conv(torch.cat([up1, upsample2x_nearest(x)], 1))
            elif self.fuse_upsample:
                x = upsample2x_add(x.permute(0, 2, 3, 1),
                                   up1.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            else:
                x = up1 + upsample2x_nearest(x)
        return x
