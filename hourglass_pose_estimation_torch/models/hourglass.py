"""Stacked-hourglass network (Newell et al., ECCV 2016), train and eval
forwards.

Port of `hourglass_pose_estimation_tpu/models/hourglass.py::HourglassNet`
and its `hg` factory. Same structure and parameter counts (1/2/8 stacks =
3.59M/6.73M/25.59M full, 1.21M/2.31M/8.88M mobile), same submodule names
as the flax paths (`conv1`, `bn1`, `layer1..3`, `hg{i}`, `res{i}`,
`fc{i}`, `fc_bn{i}`, `score{i}`, `fc_back{i}`, `score_back{i}`):

  stem:  conv7x7/2 (3->64) + BN + ReLU -> bottleneck(64->128)
         -> maxpool/2 -> bottleneck(128->256) -> bottleneck(256->2F)
  stack: hourglass(depth 4, 2F ch) -> bottleneck chain -> 1x1 conv +
         BN + ReLU ("fc") -> 1x1 score head (J maps);
         inter-stack fusion x <- x + fc_back(y) + score_back(score).

Input [B, H, W, 3] (NHWC, any float dtype); output the stacked per-stack
heatmaps [S, B, H/4, W/4, J] in `out_dtype` (f32). `forward(x, train=True)`
normalises with batch statistics (from the first `bn_stat_samples`
samples when set) and updates the running averages.

`remat=True` rematerialises each hourglass in the backward, as
`nn.remat(Hourglass)` does in the JAX package: its activations are not
kept, and the backward runs its forward again
(`torch.utils.checkpoint`, non-reentrant). That second forward moves no
running average (`norm.running_stats_frozen`), so they move once a step.
With cross-rank BatchNorm (`bn_axis_name='data'`) it issues the
statistics' all-reduces again, inside the backward; every rank runs the
same graph, so every rank issues them in the same order.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.models.modules import (
    Bottleneck, Conv, Hourglass, ResidualChain, max_pool)
from hourglass_pose_estimation_torch.models.norm import (
    BatchNorm, running_stats_frozen, sync_batch_norm)


class HourglassNet(nn.Module):
    def __init__(self, num_stacks: int = 2, num_blocks: int = 1,
                 num_classes: int = 16, mobile: bool = False,
                 skip_mode: str = 'sum', num_feats: int = 128,
                 dtype=torch.bfloat16, out_dtype=torch.float32,
                 fuse_upsample: bool = False, fuse_block: bool = False,
                 bn_stat_samples: int = 0, remat: bool = False):
        super().__init__()
        self.num_stacks = num_stacks
        self.remat = remat
        self.compute_dtype, self.out_dtype = dtype, out_dtype
        self.fuse_upsample = fuse_upsample     # also routes the stem pool
        ch = num_feats * 2
        bneck = lambda in_ch, planes: Bottleneck(
            in_ch, planes, mobile=mobile, dtype=dtype, fuse_block=fuse_block)
        conv1x1 = lambda i, o: Conv(i, o, 1, dtype=dtype)
        self.conv1 = Conv(3, 64, 7, stride=2, dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.layer1 = bneck(64, 64)
        self.layer2 = bneck(128, 128)
        self.layer3 = bneck(256, num_feats)
        for i in range(num_stacks):
            self.add_module(f'hg{i}', Hourglass(
                num_feats, depth=4, num_blocks=num_blocks, mobile=mobile,
                skip_mode=skip_mode, dtype=dtype,
                fuse_upsample=fuse_upsample, fuse_block=fuse_block))
            self.add_module(f'res{i}', ResidualChain(
                num_feats, num_blocks, mobile, dtype, fuse_block=fuse_block))
            self.add_module(f'fc{i}', conv1x1(ch, ch))
            self.add_module(f'fc_bn{i}', BatchNorm(ch))
            self.add_module(f'score{i}', conv1x1(ch, num_classes))
            if i < num_stacks - 1:
                self.add_module(f'fc_back{i}', conv1x1(ch, ch))
                self.add_module(f'score_back{i}', conv1x1(num_classes, ch))
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.stat_samples = bn_stat_samples

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: [B, H, W, 3] -> [S, B, H/4, W/4, num_classes]."""
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x = self.bn1(self.conv1(x), train, relu=True, out_dtype=dt)
        x = self.layer1(x, train)
        x = max_pool(x, self.fuse_upsample)
        x = self.layer2(x, train)
        x = self.layer3(x, train)
        outs = []
        for i in range(self.num_stacks):
            m = lambda name: getattr(self, f'{name}{i}')
            y = m('res')(self._hourglass(m('hg'), x, train), train)
            y = m('fc_bn')(m('fc')(y), train, relu=True, out_dtype=dt)
            score = m('score')(y)
            outs.append(score.to(self.out_dtype).permute(0, 2, 3, 1))
            if i < self.num_stacks - 1:
                x = x + m('fc_back')(y) + m('score_back')(score)
        return torch.stack(outs, 0)

    def _hourglass(self, hg: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return hg(x, train)
        runs = []

        def run(x):
            # the first run is the forward; any later one is the backward's
            # recomputation, whose statistics updates would be the second
            with running_stats_frozen(hg, frozen=bool(runs)):
                runs.append(1)
                return hg(x, train)

        return checkpoint(run, x, use_reentrant=False)


def _set_bn(module: nn.Module, stat_samples: int, fast_variance: bool) -> None:
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.stat_samples, m.fast_variance = stat_samples, fast_variance


class HourglassStem(nn.Module):
    """The trunk before the stacks of `HourglassNet` (conv1 .. layer3), the
    port of the JAX package's `HourglassStem`: the unit of stage 0 of the
    pipeline (`parallel/pipeline.py`). Its submodule names are
    HourglassNet's (`conv1`, `bn1`, `layer1..3`), so a HourglassNet
    state_dict splits onto it. [B, H, W, 3] -> the features [B, 2F, H/4,
    W/4] in `dtype`, channels-last. `fuse_upsample` routes the pool through
    the pool kernel, as HourglassNet's does."""

    def __init__(self, num_feats: int = 128, mobile: bool = False, dtype=torch.bfloat16,
                 bn_stat_samples: int = 0, bn_fast_variance: bool = True,
                 fuse_upsample: bool = False, fuse_block: bool = False):
        super().__init__()
        self.compute_dtype, self.fuse_upsample = dtype, fuse_upsample
        self.out_channels = num_feats * 2
        bneck = lambda in_ch, planes: Bottleneck(
            in_ch, planes, mobile=mobile, dtype=dtype, fuse_block=fuse_block)
        self.conv1 = Conv(3, 64, 7, stride=2, dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.layer1 = bneck(64, 64)
        self.layer2 = bneck(128, 128)
        self.layer3 = bneck(256, num_feats)
        _set_bn(self, bn_stat_samples, bn_fast_variance)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x = self.bn1(self.conv1(x), train, relu=True, out_dtype=dt)
        x = self.layer1(x, train)
        x = max_pool(x, self.fuse_upsample)
        return self.layer3(self.layer2(x, train), train)

    @classmethod
    def of(cls, net: HourglassNet) -> 'HourglassStem':
        """`net`'s stem, holding `net`'s own submodules: its live
        parameters and statistics, no copy."""
        stem = _shell(cls, net, {n: getattr(net, n) for n in STEM_NAMES})
        stem.fuse_upsample, stem.out_channels = net.fuse_upsample, net.fc0.in_channels
        return stem


class HourglassStack(nn.Module):
    """One stack of `HourglassNet` (hourglass, residual chain, fc + BN +
    ReLU, score head, feedback convs), the port of the JAX package's
    `HourglassStack`: the unit that pipeline stages hold. Submodule names
    are HourglassNet's per-stack names less the index (`hg`, `res`, `fc`,
    `fc_bn`, `score`, `fc_back`, `score_back`). The feedback convs exist on
    every stack, the last one's included (HourglassNet has none there;
    `split_hourglass_variables` zero-fills them and the last stage drops
    its x_next). x [B, 2F, h, w] -> (score [B, h, w, J] in `out_dtype`,
    x_next [B, 2F, h, w] in `dtype`)."""

    def __init__(self, num_feats: int = 128, num_blocks: int = 1, num_classes: int = 16,
                 mobile: bool = False, skip_mode: str = 'sum', depth: int = 4,
                 dtype=torch.bfloat16, out_dtype=torch.float32, bn_stat_samples: int = 0,
                 bn_fast_variance: bool = True, fuse_upsample: bool = False,
                 fuse_block: bool = False):
        super().__init__()
        self.compute_dtype, self.out_dtype = dtype, out_dtype
        ch = num_feats * 2
        conv1x1 = lambda i, o: Conv(i, o, 1, dtype=dtype)
        self.hg = Hourglass(num_feats, depth=depth, num_blocks=num_blocks, mobile=mobile,
                            skip_mode=skip_mode, dtype=dtype, fuse_upsample=fuse_upsample,
                            fuse_block=fuse_block)
        self.res = ResidualChain(num_feats, num_blocks, mobile, dtype, fuse_block=fuse_block)
        self.fc = conv1x1(ch, ch)
        self.fc_bn = BatchNorm(ch)
        self.score = conv1x1(ch, num_classes)
        self.fc_back = conv1x1(ch, ch)
        self.score_back = conv1x1(num_classes, ch)
        _set_bn(self, bn_stat_samples, bn_fast_variance)

    def forward(self, x: torch.Tensor, train: bool = False):
        y = self.res(self.hg(x, train), train)
        y = self.fc_bn(self.fc(y), train, relu=True, out_dtype=self.compute_dtype)
        score = self.score(y)
        x_next = x + self.fc_back(y) + self.score_back(score)
        return score.to(self.out_dtype).permute(0, 2, 3, 1), x_next

    @classmethod
    def of(cls, net: HourglassNet, i: int) -> 'HourglassStack':
        """Stack i of `net`, holding `net`'s own submodules (its live
        parameters and statistics, no copy); the last stack's feedback
        convs, which `net` lacks, are new and zero."""
        mods = {n: getattr(net, f'{n}{i}') for n in STACK_NAMES[:5]}
        if i < net.num_stacks - 1:
            mods.update(fc_back=getattr(net, f'fc_back{i}'),
                        score_back=getattr(net, f'score_back{i}'))
        else:
            fc, score = mods['fc'], mods['score']
            mods.update(fc_back=_zero_conv(fc.in_channels, fc.out_channels, fc),
                        score_back=_zero_conv(score.out_channels, score.in_channels, fc))
        stack = _shell(cls, net, mods)
        stack.out_dtype = net.out_dtype
        return stack


STEM_NAMES = ('conv1', 'bn1', 'layer1', 'layer2', 'layer3')
STACK_NAMES = ('hg', 'res', 'fc', 'fc_bn', 'score', 'fc_back', 'score_back')


def _shell(cls, net: HourglassNet, modules: dict) -> nn.Module:
    """A `cls` holding `modules` (in its own order), not built by its
    __init__."""
    out = cls.__new__(cls)
    nn.Module.__init__(out)
    out.compute_dtype = net.compute_dtype
    for name, module in modules.items():
        setattr(out, name, module)
    return out


def _zero_conv(in_ch: int, out_ch: int, like: Conv) -> Conv:
    """A zero 1x1 Conv placed as `like` (device, parameter dtype,
    channels-last); it draws nothing from the global generator."""
    with torch.device('meta'):
        conv = Conv(in_ch, out_ch, 1, dtype=like.compute_dtype)
    conv = conv.to_empty(device=like.weight.device).to(
        like.weight.dtype, memory_format=torch.channels_last)
    with torch.no_grad():
        for t in conv.parameters():
            t.zero_()
    return conv


def hg(device='cuda', **kwargs) -> HourglassNet:
    """Factory with the JAX package's kwarg surface (`hg(**kwargs)`),
    built on `device` in channels-last memory format. Accepts and ignores
    `out_res` like the reference factory. `bn_axis_name='data'` syncs the
    train-mode BatchNorm statistics over the data-parallel process group
    (`norm.sync_batch_norm`)."""
    if kwargs.get('up_channel_num', 256) != 256:
        raise ValueError('arch=hg does not support up_channel_num '
                         '(MSPN decoder width); got '
                         f"{kwargs['up_channel_num']!r}")
    dev = resolve_device(device)
    model = HourglassNet(
        num_stacks=kwargs['num_stacks'],
        num_blocks=kwargs.get('num_blocks', 1),
        num_classes=kwargs['num_classes'],
        mobile=kwargs.get('mobile', False),
        skip_mode=kwargs.get('skip_mode', 'sum'),
        num_feats=kwargs.get('num_feats', 128),
        dtype=kwargs.get('dtype', torch.bfloat16),
        fuse_upsample=kwargs.get('fuse_upsample', False),
        fuse_block=kwargs.get('fuse_block', False),
        bn_stat_samples=kwargs.get('bn_stat_samples', 0),
        remat=kwargs.get('remat', False))
    sync_batch_norm(model, kwargs.get('bn_axis_name'))
    return model.to(dev, memory_format=torch.channels_last).eval()


hg.n_outputs = 'num_stacks'
