"""Plain reference of MSPN (Li et al., "Rethinking on Multi-Stage Networks
for Human Pose Estimation", arXiv:1901.00148), f32, NCHW.

Top: 7x7/2 conv + BN + ReLU, then a 3x3/2 max-pool (padding 1). Each
stage: a ResNet-50 trunk ([3, 4, 6, 3] post-activation bottlenecks, x4
expansion, a conv + BN shortcut where the shape changes), to whose layer
outputs a later stage adds the previous stage's two skips; then a decoder
of four units, coarsest first: a 1x1 conv + BN of the trunk feature, plus
(below the first) a 1x1 conv + BN of the coarser unit's output resized to
this size (bilinear, align corners), ReLU; a 1x1 conv + BN + ReLU and a 3x3
conv + BN give the unit's J maps, resized to the output size. All but the
last stage make the skips (1x1 conv + BN + ReLU of the trunk feature and
of the unit's output) and, in the finest unit, a 1x1 conv + BN + ReLU to 64
channels that is the next stage's input. The output stacks every unit's
maps, stage-major, coarsest first: [4S, B, out, out, J].

Submodule names are the program's. `checkpointed=True` recomputes the top
and each trunk layer and decoder unit in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hpe_bench.reference.layers import BatchNorm, Conv

PLANES = (64, 128, 256, 512)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, relu=True):
        super().__init__()
        self.relu = relu
        self.conv, self.bn = Conv(cin, cout, k, stride), BatchNorm(cout)

    def forward(self, x, train):
        y = self.bn(self.conv(x), train)
        return F.relu(y) if self.relu else y


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.cbr1 = ConvBN(cin, planes, 1)
        self.cbr2 = ConvBN(planes, planes, 3, stride)
        self.cbr3 = ConvBN(planes, 4 * planes, 1, relu=False)
        self.downsample = (ConvBN(cin, 4 * planes, 1, stride, relu=False)
                           if stride != 1 or cin != 4 * planes else None)

    def forward(self, x, train):
        out = self.cbr3(self.cbr2(self.cbr1(x, train), train), train)
        return F.relu(out + (x if self.downsample is None else self.downsample(x, train)))


def _resize(x, hw):
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode='bilinear', align_corners=True)


class Unit(nn.Module):
    def __init__(self, ind, cin, joints, out_hw, width=256, skips=False, cross=False):
        super().__init__()
        self.out_hw = out_hw
        self.u_skip = ConvBN(cin, width, 1, relu=False)
        self.up_conv = ConvBN(width, width, 1, relu=False) if ind > 0 else None
        self.res_conv1 = ConvBN(width, width, 1)
        self.res_conv2 = ConvBN(width, joints, 3, relu=False)
        self.skip1 = ConvBN(cin, cin, 1) if skips else None
        self.skip2 = ConvBN(width, cin, 1) if skips else None
        self.cross_conv = ConvBN(width, 64, 1) if ind == 3 and cross else None

    def forward(self, x, up_x, train):
        out = self.u_skip(x, train)
        if self.up_conv is not None:
            out = out + self.up_conv(_resize(up_x, x.shape[2:]), train)
        out = F.relu(out)
        res = _resize(self.res_conv2(self.res_conv1(out, train), train), self.out_hw)
        s1 = self.skip1(x, train) if self.skip1 is not None else None
        s2 = self.skip2(out, train) if self.skip2 is not None else None
        cross = self.cross_conv(out, train) if self.cross_conv is not None else None
        return out, res, s1, s2, cross


class Trunk(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), has_skip=False):
        super().__init__()
        self.layers, self.has_skip = layers, has_skip
        cin = 64
        for li, (planes, blocks) in enumerate(zip(PLANES, layers)):
            for b in range(blocks):
                stride = (1 if li == 0 else 2) if b == 0 else 1
                self.add_module(f'layer{li + 1}_block{b}', Bottleneck(cin, planes, stride))
                cin = 4 * planes

    def layer(self, li, x, train):
        for b in range(self.layers[li]):
            x = getattr(self, f'layer{li + 1}_block{b}')(x, train)
        return x


class Stage(nn.Module):
    def __init__(self, joints, out_hw, has_skip, gen_skip, width=256):
        super().__init__()
        self.downsample = Trunk(has_skip=has_skip)
        for u, planes in enumerate(reversed(PLANES)):
            self.add_module(f'up{u + 1}', Unit(u, 4 * planes, joints, out_hw, width,
                                               skips=gen_skip, cross=gen_skip))


class MSPN(nn.Module):
    def __init__(self, num_stacks=2, num_classes=16, out_res=64, width=256,
                 checkpointed=False):
        super().__init__()
        self.num_stacks, self.checkpointed = num_stacks, checkpointed
        self.top = ConvBN(3, 64, 7, 2)
        for i in range(num_stacks):
            last = i == num_stacks - 1
            self.add_module(f'stage{i}', Stage(num_classes, (out_res, out_res), i > 0,
                                               not last, width))

    def _top(self, x, train):
        return F.max_pool2d(self.top(x, train), 3, 2, 1)

    def forward(self, x, train: bool = False):
        """x [B, H, W, 3] normalised -> [4S, B, out, out, J] f32."""
        run = ((lambda f, *a: checkpoint(f, *a, use_reentrant=False))
               if self.checkpointed and torch.is_grad_enabled() else (lambda f, *a: f(*a)))
        x = run(self._top, x.permute(0, 3, 1, 2).contiguous(), train)
        outputs, skip1, skip2 = [], None, None
        for i in range(self.num_stacks):
            stage = getattr(self, f'stage{i}')
            trunk = stage.downsample
            feats = []
            for li in range(4):
                x = run(trunk.layer, li, x, train)
                if trunk.has_skip:
                    x = x + skip1[li] + skip2[li]
                feats.append(x)
            out, s1, s2, cross = None, [], [], None
            for u, f in enumerate(reversed(feats)):
                unit = getattr(stage, f'up{u + 1}')
                out, r, a, b, c = run(unit, f, out, train)
                outputs.append(r.permute(0, 2, 3, 1))
                s1.insert(0, a)
                s2.insert(0, b)
                cross = c if c is not None else cross
            skip1, skip2, x = s1, s2, cross
        return torch.stack(outputs, 0)


def build(cfg: dict, checkpointed: bool = False) -> MSPN:
    """The reference of an `mspn` configuration file."""
    return MSPN(cfg['num_stacks'], cfg['num_classes'], cfg['out_res'], cfg['up_channel_num'],
                checkpointed=checkpointed)
