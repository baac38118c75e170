"""MSPN: multi-stage ResNet-50-style pose network, train and eval forwards.

Port of `hourglass_pose_estimation_tpu/models/mspn.py` (`ConvBN`,
`MSPNBottleneck`, `DownSample`, `UpsampleUnit`, `SingleStage`, `MSPN` and
the `mspn` factory). Per stage: a ResNet-50 trunk ([3, 4, 6, 3]
post-activation bottlenecks, x4 channel expansion) whose layer outputs
take the previous stage's two skips, then a decoder of 4 units (1x1
u-skip + align-corners bilinear upsample of the coarser unit + 3x3 head
resized to out_res, and the skips and the cross conv for the next stage).
The forward returns ONE stacked f32 tensor [S*4, B, out_res, out_res, J],
stage-major, coarsest head first, so the per-stack heatmap loss and PCK
(the last head) apply unchanged.

Same submodule names as the flax paths (`top`, `stage{i}.downsample.
layer{l}_block{b}.cbr1`, `stage{i}.up{u}.u_skip`, ..., `conv`/`bn` in each
ConvBN), which is what `weights.py` and `interop.py` rely on. The same
casts as the JAX model: a ConvBN returns the compute dtype after its ReLU,
the residual add, the trunk's skip-adds and the decoder's `out + up_x` run
in the compute dtype, and the heads become f32 only when stacked.
Structure: 25,132,480 parameters at 1 stage, 56,848,576 at 2 (16 joints,
decoder width 256, non-mobile). Init: Kaiming fan-out normal on every conv
with zero biases, BatchNorm scale 1 and bias 0 (0 on each `cbr3` scale
under `zero_init_residual`), drawn from the global generator (the Trainer
seeds it under `fork_rng`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.models.modules import Conv
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.ops.resize import resize_bilinear_align_corners

TRUNK_PLANES = (64, 128, 256, 512)
EXPANSION = 4


def _resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Align-corners resize of an NCHW (channels-last) tensor."""
    return resize_bilinear_align_corners(x.permute(0, 2, 3, 1), out_hw).permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """Conv + BN (+ ReLU), the result in the compute dtype; `mobile` makes
    the conv depthwise."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1,
                 relu: bool = True, mobile: bool = False, zero_bn: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.relu = relu
        self.compute_dtype = dtype
        self.conv = Conv(in_ch, out_ch, kernel, stride,
                         groups=out_ch if mobile else 1, dtype=dtype)
        self.bn = BatchNorm(out_ch)
        if zero_bn:
            nn.init.zeros_(self.bn.weight)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.bn(self.conv(x), train)
        if self.relu:
            y = torch.relu(y)
        return y.to(self.compute_dtype)


class MSPNBottleneck(nn.Module):
    """Post-activation ResNet bottleneck, expansion 4; a ConvBN shortcut
    (`downsample`) iff stride != 1 or in_ch != 4 * planes."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, mobile: bool = False,
                 zero_init_residual: bool = False, dtype=torch.bfloat16):
        super().__init__()
        c_out = planes * EXPANSION
        self.compute_dtype = dtype
        self.cbr1 = ConvBN(in_ch, planes, 1, 1, True, dtype=dtype)
        self.cbr2 = ConvBN(planes, planes, 3, stride, True, mobile=mobile, dtype=dtype)
        self.cbr3 = ConvBN(planes, c_out, 1, 1, False, zero_bn=zero_init_residual,
                           dtype=dtype)
        self.downsample = (ConvBN(in_ch, c_out, 1, stride, False, dtype=dtype)
                           if stride != 1 or in_ch != c_out else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.cbr3(self.cbr2(self.cbr1(x, train), train), train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return torch.relu(out + x).to(self.compute_dtype)


class DownSample(nn.Module):
    """The ResNet-50 trunk, with the previous stage's skips added to each
    layer's output when `has_skip`. Returns (x4, x3, x2, x1), coarsest
    first. Only the first block of each layer takes `mobile`, as in the
    reference."""

    def __init__(self, in_ch: int = 64, layers=(3, 4, 6, 3), has_skip: bool = False,
                 zero_init_residual: bool = False, mobile: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.layers, self.has_skip = tuple(layers), has_skip
        for li, (planes, blocks) in enumerate(zip(TRUNK_PLANES, self.layers)):
            for b in range(blocks):
                self.add_module(f'layer{li + 1}_block{b}', MSPNBottleneck(
                    in_ch, planes, (1 if li == 0 else 2) if b == 0 else 1,
                    mobile=mobile and b == 0, zero_init_residual=zero_init_residual,
                    dtype=dtype))
                in_ch = planes * EXPANSION

    def forward(self, x, skip1=None, skip2=None, train: bool = False):
        outs = []
        for li, blocks in enumerate(self.layers):
            for b in range(blocks):
                x = getattr(self, f'layer{li + 1}_block{b}')(x, train)
            if self.has_skip:
                x = x + skip1[li] + skip2[li]
            outs.append(x)
        x1, x2, x3, x4 = outs
        return x4, x3, x2, x1


class UpsampleUnit(nn.Module):
    """One decoder unit on a trunk feature of `in_ch` channels: -> (out,
    the head resized to `output_shape`, skip1, skip2, cross), the last
    three None where the unit makes none."""

    def __init__(self, ind: int, in_ch: int, output_chl_num: int, output_shape,
                 chl_num: int = 256, gen_skip: bool = False, gen_cross_conv: bool = False,
                 mobile: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.ind, self.output_shape = ind, tuple(output_shape)
        self.compute_dtype = dtype
        self.u_skip = ConvBN(in_ch, chl_num, 1, 1, False, dtype=dtype)
        self.up_conv = (ConvBN(chl_num, chl_num, 1, 1, False, mobile=mobile, dtype=dtype)
                        if ind > 0 else None)
        self.res_conv1 = ConvBN(chl_num, chl_num, 1, 1, True, mobile=mobile, dtype=dtype)
        self.res_conv2 = ConvBN(chl_num, output_chl_num, 3, 1, False, dtype=dtype)
        self.skip1 = self.skip2 = self.cross_conv = None
        if gen_skip:
            self.skip1 = ConvBN(in_ch, in_ch, 1, 1, True, mobile=mobile, dtype=dtype)
            self.skip2 = ConvBN(chl_num, in_ch, 1, 1, True, dtype=dtype)
        if ind == 3 and gen_cross_conv:
            self.cross_conv = ConvBN(chl_num, 64, 1, 1, True, dtype=dtype)

    def forward(self, x, up_x=None, train: bool = False):
        out = self.u_skip(x, train)
        if self.up_conv is not None:
            up_x = self.up_conv(_resize(up_x, x.shape[2:]), train)
            out = out + up_x
        out = torch.relu(out).to(self.compute_dtype)
        res = self.res_conv2(self.res_conv1(out, train), train)
        res = _resize(res, self.output_shape)
        skip1 = skip2 = cross = None
        if self.skip1 is not None:
            skip1 = self.skip1(x, train)
            skip2 = self.skip2(out, train)
        if self.cross_conv is not None:
            cross = self.cross_conv(out, train)
        return out, res, skip1, skip2, cross


class SingleStage(nn.Module):
    """Trunk + decoder. The decoder's inter-unit upsample targets are the
    trunk's own feature sizes (as in the JAX model, right for any
    out_res)."""

    def __init__(self, output_chl_num: int, output_shape, has_skip: bool = False,
                 gen_skip: bool = False, gen_cross_conv: bool = False, chl_num: int = 256,
                 zero_init_residual: bool = False, mobile: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.downsample = DownSample(has_skip=has_skip, zero_init_residual=zero_init_residual,
                                     mobile=mobile, dtype=dtype)
        for u, planes in enumerate(reversed(TRUNK_PLANES)):
            self.add_module(f'up{u + 1}', UpsampleUnit(
                u, planes * EXPANSION, output_chl_num, output_shape, chl_num=chl_num,
                gen_skip=gen_skip, gen_cross_conv=gen_cross_conv, mobile=mobile,
                dtype=dtype))

    def forward(self, x, skip1=None, skip2=None, train: bool = False):
        feats = self.downsample(x, skip1, skip2, train)
        out, res, s1, s2 = None, [], [], []
        cross = None
        for u, f in enumerate(feats):
            out, r, a, b, c = getattr(self, f'up{u + 1}')(f, out, train)
            res.append(r)
            s1.insert(0, a)
            s2.insert(0, b)
            cross = c if c is not None else cross
        return res, s1, s2, cross


class MSPN(nn.Module):
    def __init__(self, num_stacks: int = 2, num_classes: int = 16, out_res: int = 64,
                 up_channel_num: int = 256, mobile: bool = False,
                 zero_init_residual: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.num_stacks, self.num_classes = num_stacks, num_classes
        self.out_res, self.up_channel_num = out_res, up_channel_num
        self.compute_dtype = dtype
        self.top = ConvBN(3, 64, 7, 2, True, dtype=dtype)
        for i in range(num_stacks):
            last = i == num_stacks - 1
            self.add_module(f'stage{i}', SingleStage(
                num_classes, (out_res, out_res), has_skip=i > 0, gen_skip=not last,
                gen_cross_conv=not last, chl_num=up_channel_num,
                zero_init_residual=zero_init_residual, mobile=mobile, dtype=dtype))
        for m in self.modules():
            if isinstance(m, Conv):
                nn.init.kaiming_normal_(m.weight, mode='fan_out', nonlinearity='relu')
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: [B, H, W, 3] -> [num_stacks*4, B, out_res, out_res, J] f32."""
        x = self.top(x.permute(0, 3, 1, 2).to(self.compute_dtype), train)
        x = F.max_pool2d(x, 3, 2, 1)
        outputs, skip1, skip2 = [], None, None
        for i in range(self.num_stacks):
            res, skip1, skip2, x = getattr(self, f'stage{i}')(x, skip1, skip2, train)
            outputs += [r.permute(0, 2, 3, 1).to(torch.float32) for r in res]
        return torch.stack(outputs, 0)


def mspn(device='cuda', **kwargs) -> MSPN:
    """Factory with the JAX package's kwarg surface, built on `device` in
    channels-last memory format. Ignores `num_blocks` (the reference
    overloads it as the decoder width, which would build a 1-channel
    decoder); `up_channel_num` (default 256) is the width. Raises on what
    MSPN does not implement rather than ignore it: a true `remat`,
    `bn_stat_samples`, `bn_axis_name`, `fuse_block` or `fuse_upsample`
    (the hourglass's kernel switches), and `skip_mode` other than 'sum'."""
    for opt in ('remat', 'bn_stat_samples', 'bn_axis_name', 'fuse_block', 'fuse_upsample'):
        if kwargs.get(opt):
            raise ValueError(f'arch=mspn does not support {opt}; got {opt}={kwargs[opt]!r}')
    if kwargs.get('skip_mode', 'sum') != 'sum':
        raise ValueError("arch=mspn does not support skip_mode="
                         f"{kwargs['skip_mode']!r} (fixed skip structure)")
    dev = resolve_device(device)
    model = MSPN(num_stacks=kwargs['num_stacks'], num_classes=kwargs['num_classes'],
                 out_res=kwargs.get('out_res', 64),
                 up_channel_num=kwargs.get('up_channel_num', 256),
                 mobile=kwargs.get('mobile', False),
                 zero_init_residual=kwargs.get('zero_init_residual', False),
                 dtype=kwargs.get('dtype', torch.bfloat16))
    return model.to(dev, memory_format=torch.channels_last).eval()

