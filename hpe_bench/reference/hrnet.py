"""Plain reference of HRNet (Sun et al., "Deep High-Resolution
Representation Learning for Human Pose Estimation", CVPR 2019,
arXiv:1902.09212), f32, NCHW, as the released `pose_hrnet.py` builds it.

Stem: two 3x3/2 conv + BN + ReLU of 64. Layer 1: four post-activation
bottlenecks of 64 planes (x4 expansion; a 1x1 conv + BN shortcut on the
first). Stages 2, 3 and 4: `stage_modules` modules over 2, 3 and 4
branches at 1/4 to 1/32 of the input, widths `width` x (1, 2, 4, 8), each
branch `branch_blocks` BasicBlocks (3x3 conv + BN + ReLU, 3x3 conv + BN,
plus the input, ReLU). A module's exchange makes output i as
ReLU(sum over j of t_ij): t_ii is branch i; a coarser j, a 1x1 conv + BN
upsampled (nearest) by 2^(j-i); a finer j, (i - j) 3x3/2 conv + BN with
a ReLU between them. The last module makes output 0 alone. A transition
makes each new branch by a 3x3/2 conv + BN + ReLU of the coarsest branch
(and turns layer 1's 256 channels into `width` by a 3x3 conv + BN +
ReLU). The head: a 1x1 conv to J maps.

Departures from the released model, which the program keeps too: every
convolution carries a bias (the released code has none ahead of a BN,
where a bias has no effect in training); the input is square (256^2 with
16 MPII joints here; the paper's W48 results are COCO's 256x192 and
384x288 with 17); the output is stacked as one stack, [1, B, out, out,
J], so the per-stack loss takes it; conv weights are whatever the caller
loads (no init of the released code's). Submodule names are the
program's. `checkpointed=True` recomputes the stem, layer 1 and each
module in the backward (torch.utils.checkpoint), so that a train step at
the program's batch fits the card in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hpe_bench.reference.layers import BatchNorm, Conv


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, relu=True):
        super().__init__()
        self.relu = relu
        self.conv, self.bn = Conv(cin, cout, k, stride), BatchNorm(cout)

    def forward(self, x, train):
        y = self.bn(self.conv(x), train)
        return F.relu(y) if self.relu else y


class Bottleneck(nn.Module):
    def __init__(self, cin, planes):
        super().__init__()
        self.cbr1 = ConvBN(cin, planes, 1)
        self.cbr2 = ConvBN(planes, planes, 3)
        self.cbr3 = ConvBN(planes, 4 * planes, 1, relu=False)
        self.downsample = ConvBN(cin, 4 * planes, 1, relu=False) if cin != 4 * planes else None

    def forward(self, x, train):
        out = self.cbr3(self.cbr2(self.cbr1(x, train), train), train)
        return F.relu(out + (x if self.downsample is None else self.downsample(x, train)))


class BasicBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.cbr1 = ConvBN(ch, ch, 3)
        self.cb2 = ConvBN(ch, ch, 3, relu=False)

    def forward(self, x, train):
        return F.relu(self.cb2(self.cbr1(x, train), train) + x)


class Exchange(nn.Module):
    def __init__(self, widths, outputs):
        super().__init__()
        self.n, self.outputs = len(widths), outputs
        for i in range(outputs):
            for j in range(self.n):
                if j > i:
                    self.add_module(f'fuse{i}_{j}', ConvBN(widths[j], widths[i], 1, relu=False))
                elif j < i:
                    chain = nn.Module()
                    for k in range(i - j):
                        last = k == i - j - 1
                        chain.add_module(f'down{k}', ConvBN(
                            widths[j], widths[i] if last else widths[j], 3, 2, relu=not last))
                    self.add_module(f'fuse{i}_{j}', chain)

    def forward(self, xs, train):
        out = []
        for i in range(self.outputs):
            y = xs[i]
            for j in range(self.n):
                if j > i:
                    t = getattr(self, f'fuse{i}_{j}')(xs[j], train)
                    y = y + F.interpolate(t, scale_factor=2 ** (j - i), mode='nearest')
                elif j < i:
                    t = xs[j]
                    for k in range(i - j):
                        t = getattr(getattr(self, f'fuse{i}_{j}'), f'down{k}')(t, train)
                    y = y + t
            out.append(F.relu(y))
        return out


class Module(nn.Module):
    def __init__(self, widths, blocks, outputs):
        super().__init__()
        self.blocks = blocks
        for i, w in enumerate(widths):
            branch = nn.Module()
            for b in range(blocks):
                branch.add_module(f'block{b}', BasicBlock(w))
            self.add_module(f'branch{i}', branch)
        self.exchange = Exchange(widths, outputs)

    def forward(self, train, *xs):
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.blocks):
                x = getattr(getattr(self, f'branch{i}'), f'block{b}')(x, train)
            ys.append(x)
        return tuple(self.exchange(ys, train))


class HRNet(nn.Module):
    def __init__(self, num_classes=16, width=48, branch_blocks=4, stage_modules=(1, 4, 3),
                 checkpointed=False):
        super().__init__()
        self.stage_modules, self.checkpointed = tuple(stage_modules), checkpointed
        self.stem1, self.stem2 = ConvBN(3, 64, 3, 2), ConvBN(64, 64, 3, 2)
        self.layer1 = nn.Module()
        for b in range(4):
            self.layer1.add_module(f'block{b}', Bottleneck(64 if b == 0 else 256, 64))
        prev = [256]
        for s, modules in enumerate(self.stage_modules):
            widths = [width * 2 ** i for i in range(s + 2)]
            transition = nn.Module()
            for i, w in enumerate(widths):
                if i >= len(prev):
                    transition.add_module(f'branch{i}', ConvBN(prev[-1], w, 3, 2))
                elif prev[i] != w:
                    transition.add_module(f'branch{i}', ConvBN(prev[i], w, 3))
            self.add_module(f'transition{s + 1}', transition)
            stage = nn.Module()
            for m in range(modules):
                last = s == len(self.stage_modules) - 1 and m == modules - 1
                stage.add_module(f'module{m}', Module(widths, branch_blocks,
                                                      1 if last else len(widths)))
            self.add_module(f'stage{s + 2}', stage)
            prev = widths
        self.head = Conv(width, num_classes, 1)

    def _stem(self, x, train):
        x = self.stem2(self.stem1(x, train), train)
        for b in range(4):
            x = getattr(self.layer1, f'block{b}')(x, train)
        return x

    def forward(self, x, train: bool = False):
        """x [B, H, W, 3] normalised -> [1, B, H/4, W/4, J] f32."""
        run = ((lambda f, *a: checkpoint(f, *a, use_reentrant=False))
               if self.checkpointed and torch.is_grad_enabled() else (lambda f, *a: f(*a)))
        xs = [run(self._stem, x.permute(0, 3, 1, 2).contiguous(), train)]
        for s, modules in enumerate(self.stage_modules):
            transition = getattr(self, f'transition{s + 1}')
            xs = [getattr(transition, f'branch{i}')(xs[min(i, len(xs) - 1)], train)
                  if hasattr(transition, f'branch{i}') else xs[i] for i in range(s + 2)]
            stage = getattr(self, f'stage{s + 2}')
            for m in range(modules):
                xs = list(run(getattr(stage, f'module{m}'), train, *xs))
        return self.head(xs[0]).permute(0, 2, 3, 1)[None]


def build(cfg: dict, checkpointed: bool = False) -> HRNet:
    """The reference of an `hrnet` configuration file: its `model` keys
    (`width`, `branch_blocks`, `stage_modules`), as the program reads them."""
    return HRNet(cfg['num_classes'], **cfg['model'], checkpointed=checkpointed)
