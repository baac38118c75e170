"""HRNet: high-resolution pose network, train and eval forwards.

Sun et al., "Deep High-Resolution Representation Learning for Human Pose
Estimation", CVPR 2019 (arXiv:1902.09212), as its released
`pose_hrnet.py` builds W48. The JAX package has no counterpart: this
model is the port's own, held to the benchmark's plain reference
(`hpe_bench/reference/hrnet.py`).

Stem: two 3x3/2 ConvBN-ReLUs of 64. Layer 1: four post-activation
bottlenecks of 64 planes (MSPN's, x4 expansion). Stages 2, 3 and 4 hold
`stage_modules` modules over 2, 3 and 4 parallel branches at 1/4, 1/8,
1/16 and 1/32 of the input, of widths `width` x (1, 2, 4, 8); each branch
holds `branch_blocks` BasicBlocks (two 3x3 ConvBNs and the identity).
Each module ends in an exchange unit: output i is ReLU(sum_j t_ij), with
t_ii branch i; for a coarser j a 1x1 ConvBN, then nearest upsampling by
2^(j-i); for a finer j, (i - j) strided 3x3 ConvBNs, ReLU between them.
The last module outputs only the 1/4 branch. A transition adds each new
branch with a 3x3/2 ConvBN-ReLU of the coarsest one. The head is a 1x1
conv to J maps. The forward returns [1, B, out, out, J] f32, as the
per-stack loss takes it.

In the exchange, each 2x term is added through the upsample kernel
(`ops/hopper/upsample.py::upsample2x_add`, on the NHWC view of a
channels-last tensor); the 4x and 8x terms are plain nearest upsamples
and adds. Each exchange is a `train.exchange` span (`utils/tracing.py`),
recorded only under a profiler or `tracing.enable()`.

Casts as MSPN's: a ConvBN returns the compute dtype, the residual adds and
the exchange's sum run in it. Every BatchNorm is `models/norm.py`'s (the
fused train-mode kernels on the card). Init (the released code's):
conv weights N(0, 0.001), zero biases, BatchNorm scale 1 and shift 0, from
the global generator. W48 at 16 joints: 63,635,488 parameters (the
released structure's 63,595,696 and a bias on each of its other
convolutions, as every conv of the port has one), 292 BatchNorms.
"""

from __future__ import annotations

import torch
from torch import nn

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.models.modules import Conv
from hourglass_pose_estimation_torch.models.mspn import ConvBN, MSPNBottleneck
from hourglass_pose_estimation_torch.ops.hopper import upsample2x_add
from hourglass_pose_estimation_torch.utils import tracing

STEM_WIDTH = 64
LAYER1_BLOCKS = 4


def nearest_up(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW (channels-last) tensor by an
    integer `factor`; the result is channels-last."""
    B, C, H, W = x.shape
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(B, H, factor, W, factor, C)
    return y.reshape(B, H * factor, W * factor, C).permute(0, 3, 1, 2)


class BasicBlock(nn.Module):
    """Two 3x3 ConvBNs (the first with its ReLU) and the identity, then
    the ReLU."""

    def __init__(self, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        self.cbr1 = ConvBN(ch, ch, 3, 1, True, dtype=dtype)
        self.cb2 = ConvBN(ch, ch, 3, 1, False, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.cb2(self.cbr1(x, train), train) + x).to(self.compute_dtype)


class Exchange(nn.Module):
    """The exchange unit of a module of `widths` branches, making
    `outputs` of them (all, or the finest alone)."""

    def __init__(self, widths, outputs: int, dtype=torch.bfloat16):
        super().__init__()
        self.n, self.outputs = len(widths), outputs
        self.compute_dtype = dtype
        for i in range(outputs):
            for j in range(self.n):
                if j > i:
                    self.add_module(f'fuse{i}_{j}', ConvBN(widths[j], widths[i], 1, 1, False,
                                                           dtype=dtype))
                elif j < i:
                    chain = nn.Module()
                    for k in range(i - j):
                        last = k == i - j - 1
                        chain.add_module(f'down{k}', ConvBN(
                            widths[j], widths[i] if last else widths[j], 3, 2, not last,
                            dtype=dtype))
                    self.add_module(f'fuse{i}_{j}', chain)

    def _term(self, i: int, j: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        """t_ij for a finer j at branch i's resolution."""
        chain = getattr(self, f'fuse{i}_{j}')
        for k in range(i - j):
            x = getattr(chain, f'down{k}')(x, train)
        return x

    def forward(self, xs, train: bool = False) -> list:
        out = []
        for i in range(self.outputs):
            y = xs[i]
            for j in range(i):
                y = y + self._term(i, j, xs[j], train)
            for j in range(i + 1, self.n):
                t = getattr(self, f'fuse{i}_{j}')(xs[j], train)
                if j == i + 1:
                    y = upsample2x_add(t.permute(0, 2, 3, 1),
                                       y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                else:
                    y = y + nearest_up(t, 2 ** (j - i))
            out.append(torch.relu(y).to(self.compute_dtype))
        return out


class HRModule(nn.Module):
    """`blocks` BasicBlocks on each branch, then the exchange."""

    def __init__(self, widths, blocks: int, multi_scale_output: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.blocks = blocks
        for i, w in enumerate(widths):
            branch = nn.Module()
            for b in range(blocks):
                branch.add_module(f'block{b}', BasicBlock(w, dtype=dtype))
            self.add_module(f'branch{i}', branch)
        self.exchange = Exchange(widths, len(widths) if multi_scale_output else 1, dtype=dtype)

    def forward(self, xs, train: bool = False) -> list:
        ys = []
        for i, x in enumerate(xs):
            branch = getattr(self, f'branch{i}')
            for b in range(self.blocks):
                x = getattr(branch, f'block{b}')(x, train)
            ys.append(x)
        with tracing.span('train.exchange'):
            return self.exchange(ys, train)


class HRNet(nn.Module):
    def __init__(self, num_classes: int = 16, width: int = 48, branch_blocks: int = 4,
                 stage_modules=(1, 4, 3), dtype=torch.bfloat16):
        super().__init__()
        self.num_classes, self.width = num_classes, width
        self.branch_blocks, self.stage_modules = branch_blocks, tuple(stage_modules)
        self.compute_dtype = dtype
        self.stem1 = ConvBN(3, STEM_WIDTH, 3, 2, True, dtype=dtype)
        self.stem2 = ConvBN(STEM_WIDTH, STEM_WIDTH, 3, 2, True, dtype=dtype)
        layer1 = nn.Module()
        cin = STEM_WIDTH
        for b in range(LAYER1_BLOCKS):
            layer1.add_module(f'block{b}', MSPNBottleneck(cin, STEM_WIDTH, dtype=dtype))
            cin = 4 * STEM_WIDTH
        self.layer1 = layer1
        prev = [cin]
        for s, modules in enumerate(self.stage_modules):
            widths = [width * 2 ** i for i in range(s + 2)]
            transition = nn.Module()
            for i, w in enumerate(widths):
                if i >= len(prev):
                    transition.add_module(f'branch{i}', ConvBN(prev[-1], w, 3, 2, True,
                                                               dtype=dtype))
                elif prev[i] != w:
                    transition.add_module(f'branch{i}', ConvBN(prev[i], w, 3, 1, True,
                                                               dtype=dtype))
            self.add_module(f'transition{s + 1}', transition)
            stage = nn.Module()
            for m in range(modules):
                last = s == len(self.stage_modules) - 1 and m == modules - 1
                stage.add_module(f'module{m}', HRModule(widths, branch_blocks,
                                                        multi_scale_output=not last,
                                                        dtype=dtype))
            self.add_module(f'stage{s + 2}', stage)
            prev = widths
        self.head = Conv(width, num_classes, 1, dtype=dtype)
        for mod in self.modules():
            if isinstance(mod, Conv):
                nn.init.normal_(mod.weight, std=0.001)
                nn.init.zeros_(mod.bias)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: [B, H, W, 3] -> [1, B, H/4, W/4, J] f32."""
        x = self.stem2(self.stem1(x.permute(0, 3, 1, 2).to(self.compute_dtype), train), train)
        for b in range(LAYER1_BLOCKS):
            x = getattr(self.layer1, f'block{b}')(x, train)
        xs = [x]
        for s, modules in enumerate(self.stage_modules):
            transition = getattr(self, f'transition{s + 1}')
            n = s + 2
            xs = [getattr(transition, f'branch{i}')(xs[min(i, len(xs) - 1)], train)
                  if hasattr(transition, f'branch{i}') else xs[i] for i in range(n)]
            stage = getattr(self, f'stage{s + 2}')
            for m in range(modules):
                xs = getattr(stage, f'module{m}')(xs, train)
        y = self.head(xs[0])
        return y.permute(0, 2, 3, 1).to(torch.float32)[None]


def hrnet(device='cuda', **kwargs) -> HRNet:
    """Factory with the port's kwarg surface, built on `device` in
    channels-last memory format. `width` (48) is the finest branch's width,
    `branch_blocks` (4) the BasicBlocks a branch of a module,
    `stage_modules` ((1, 4, 3)) the modules of stages 2, 3 and 4.
    `num_stacks` must be 1 (one output); `num_blocks` is ignored (the
    hourglass's chain length). Raises on what HRNet does not implement
    rather than ignore it: a true `remat`, `bn_stat_samples`,
    `bn_axis_name`, `mobile`, `fuse_block` or `fuse_upsample` (the
    hourglass's kernel switches), `skip_mode` other than 'sum' and an
    `up_channel_num` other than 256 (MSPN's decoder width)."""
    for opt in ('remat', 'bn_stat_samples', 'bn_axis_name', 'mobile', 'fuse_block',
                'fuse_upsample'):
        if kwargs.get(opt):
            raise ValueError(f'arch=hrnet does not support {opt}; got {opt}={kwargs[opt]!r}')
    if kwargs.get('skip_mode', 'sum') != 'sum':
        raise ValueError("arch=hrnet does not support skip_mode="
                         f"{kwargs['skip_mode']!r} (fixed exchange structure)")
    if kwargs.get('up_channel_num', 256) != 256:
        raise ValueError('arch=hrnet does not support up_channel_num (MSPN decoder width); '
                         f"got {kwargs['up_channel_num']!r}")
    if kwargs.get('num_stacks', 1) != 1:
        raise ValueError(f"arch=hrnet has one output (num_stacks=1); got {kwargs['num_stacks']!r}")
    dev = resolve_device(device)
    model = HRNet(num_classes=kwargs['num_classes'], width=kwargs.get('width', 48),
                  branch_blocks=kwargs.get('branch_blocks', 4),
                  stage_modules=tuple(kwargs.get('stage_modules', (1, 4, 3))),
                  dtype=kwargs.get('dtype', torch.bfloat16))
    return model.to(dev, memory_format=torch.channels_last).eval()
