"""Plain reference of the stacked-hourglass network (Newell et al.,
"Stacked Hourglass Networks for Human Pose Estimation", ECCV 2016,
arXiv:1603.06937), f32, NCHW.

Stem: 7x7/2 conv (3 -> 64) + BN + ReLU, bottleneck (64 -> 128), 2x2
max-pool, bottleneck (128 -> 256), bottleneck (256 -> 2F). Each stack: an
hourglass of depth 4 at 2F channels (per level a skip chain, a pool, a
chain; a chain at the bottom; per level on the way up a chain, a nearest
2x upsample and the skip added), a residual chain, 1x1 conv + BN + ReLU,
a 1x1 score conv to J maps, and for all but the last stack the maps fed
back: x + conv(y) + conv(score). The bottleneck is pre-activation:
BN-ReLU-conv 1x1 (2F -> F), BN-ReLU-conv 3x3, BN-ReLU-conv 1x1 (F -> 2F),
plus the input (through a 1x1 conv where the widths differ).

Departures from the paper that the program keeps too: sum merges, one
bottleneck per chain, convolutions with biases. Submodule names are the
program's, so its parameters load by name. `checkpointed=True` recomputes
the stem and each stack in the backward (torch.utils.checkpoint), so that
a train step at the program's batch fits the card in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hpe_bench.reference.layers import BatchNorm, Conv


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.bn1, self.conv1 = BatchNorm(cin), Conv(cin, planes, 1)
        self.bn2, self.conv2 = BatchNorm(planes), Conv(planes, planes, 3)
        self.bn3, self.conv3 = BatchNorm(planes), Conv(planes, 2 * planes, 1)
        self.downsample = Conv(cin, 2 * planes, 1) if cin != 2 * planes else None

    def forward(self, x, train):
        out = self.conv1(F.relu(self.bn1(x, train)))
        out = self.conv2(F.relu(self.bn2(out, train)))
        out = self.conv3(F.relu(self.bn3(out, train)))
        return out + (x if self.downsample is None else self.downsample(x))


class Chain(nn.Module):
    def __init__(self, planes: int):
        super().__init__()
        self.block0 = Bottleneck(2 * planes, planes)

    def forward(self, x, train):
        return self.block0(x, train)


class Hourglass(nn.Module):
    def __init__(self, planes: int, depth: int = 4):
        super().__init__()
        self.depth = depth
        for n in range(depth, 0, -1):
            self.add_module(f'up1_l{n}', Chain(planes))
            self.add_module(f'low1_l{n}', Chain(planes))
        self.low2_l1 = Chain(planes)
        for n in range(1, depth + 1):
            self.add_module(f'low3_l{n}', Chain(planes))

    def forward(self, x, train):
        skips = []
        for n in range(self.depth, 0, -1):
            skips.append(getattr(self, f'up1_l{n}')(x, train))
            x = getattr(self, f'low1_l{n}')(F.max_pool2d(x, 2, 2), train)
        x = self.low2_l1(x, train)
        for n in range(1, self.depth + 1):
            x = getattr(self, f'low3_l{n}')(x, train)
            x = skips.pop() + F.interpolate(x, scale_factor=2, mode='nearest')
        return x


class HourglassNet(nn.Module):
    def __init__(self, num_stacks: int = 8, num_feats: int = 128, num_classes: int = 16,
                 depth: int = 4, checkpointed: bool = False):
        super().__init__()
        self.num_stacks, self.checkpointed = num_stacks, checkpointed
        ch = 2 * num_feats
        self.conv1, self.bn1 = Conv(3, 64, 7, stride=2), BatchNorm(64)
        self.layer1 = Bottleneck(64, 64)
        self.layer2 = Bottleneck(128, 128)
        self.layer3 = Bottleneck(256, num_feats)
        for i in range(num_stacks):
            self.add_module(f'hg{i}', Hourglass(num_feats, depth))
            self.add_module(f'res{i}', Chain(num_feats))
            self.add_module(f'fc{i}', Conv(ch, ch, 1))
            self.add_module(f'fc_bn{i}', BatchNorm(ch))
            self.add_module(f'score{i}', Conv(ch, num_classes, 1))
            if i < num_stacks - 1:
                self.add_module(f'fc_back{i}', Conv(ch, ch, 1))
                self.add_module(f'score_back{i}', Conv(num_classes, ch, 1))

    def _stem(self, x, train):
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(self.layer1(x, train), 2, 2)
        return self.layer3(self.layer2(x, train), train)

    def _stack(self, i, x, train):
        m = lambda name: getattr(self, f'{name}{i}')
        y = m('res')(m('hg')(x, train), train)
        y = F.relu(m('fc_bn')(m('fc')(y), train))
        score = m('score')(y)
        if i < self.num_stacks - 1:
            x = x + m('fc_back')(y) + m('score_back')(score)
        return score, x

    def forward(self, x, train: bool = False):
        """x [B, H, W, 3] normalised -> [S, B, H/4, W/4, J] f32."""
        run = ((lambda f, *a: checkpoint(f, *a, use_reentrant=False))
               if self.checkpointed and torch.is_grad_enabled() else (lambda f, *a: f(*a)))
        x = run(self._stem, x.permute(0, 3, 1, 2).contiguous(), train)
        outs = []
        for i in range(self.num_stacks):
            score, x = run(self._stack, i, x, train)
            outs.append(score.permute(0, 2, 3, 1))
        return torch.stack(outs, 0)


def build(cfg: dict, checkpointed: bool = False) -> HourglassNet:
    """The reference of an `hg` configuration file."""
    return HourglassNet(cfg['num_stacks'], cfg['num_feats'], cfg['num_classes'],
                        cfg.get('depth', 4), checkpointed=checkpointed)
