"""Operations and bytes of one launch of each of the port's kernels, from its
shapes, and the roofline bound that follows.

Keyed by the `torch.library` op that launches the kernel (`hpe::<op>`),
with the substring its CUDA symbol carries in a device trace. Each input
byte is counted once as read and each output byte once as written,
whatever the kernel reads again.
"""

from __future__ import annotations

import math

from hpe_bench.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_S

BF16, F32, I32 = 2, 4, 4


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def bottleneck(x, planes: int = 128):
    """x [B, H, W, 2*planes] bf16 -> the same: 1x1 (2P -> P), 3x3 (P -> P),
    1x1 (P -> 2P) products, and x read, the folded weights read, out
    written."""
    B, H, W, C = (int(d) for d in x)
    P = planes
    flops = 2 * B * H * W * (C * P + 9 * P * P + P * C)
    weights = (C * P + 9 * P * P + P * C) * BF16 + (3 * P + C) * F32 * 2
    return flops, 2 * _numel(x) * BF16 + weights


def upsample2x_add(low, skip):
    """low [B, h, w, C] and skip [B, 2h, 2w, C] bf16 -> [B, 2h, 2w, C]."""
    return _numel(skip), (_numel(low) + 2 * _numel(skip)) * BF16


def upsample2x_add_bwd(g):
    """g [B, 2h, 2w, C] bf16 -> its 2x2 sums [B, h, w, C]."""
    return 3 * _numel(g) // 4, (_numel(g) + _numel(g) // 4) * BF16


def maxpool2x2_fwd(x):
    """x [B, H, W, C] bf16 -> [B, H/2, W/2, C]."""
    return 3 * _numel(x) // 4, (_numel(x) + _numel(x) // 4) * BF16


def maxpool2x2_bwd(x, g):
    """x [B, H, W, C] and g [B, H/2, W/2, C] bf16 -> dx [B, H, W, C]."""
    return _numel(x), (2 * _numel(x) + _numel(g)) * BF16


def render_gaussian(mu, weight, out_hw):
    """mu [B, J, 2] int32, weight [B, J] f32 -> targets [B, H, W, J] f32."""
    B, J = (int(d) for d in weight)
    out = B * int(out_hw[0]) * int(out_hw[1]) * J
    return 4 * out, _numel(mu) * I32 + _numel(weight) * F32 + out * F32


def decode_peaks(hm):
    """heatmaps [B, H, W, J] f32 -> coords [B, J, 2] and maxvals [B, J]."""
    B, H, W, J = (int(d) for d in hm)
    return _numel(hm), (_numel(hm) + 3 * B * J) * F32


# op name -> (substring of the kernel's symbol, the shapes it reads)
KERNELS = {
    'hpe::fused_bottleneck_chunked': ('bottleneck_fwd_kernel', lambda s, ctx: bottleneck(s[0])),
    'hpe::fused_bottleneck_image': ('bottleneck_image_kernel', lambda s, ctx: bottleneck(s[0])),
    'hpe::upsample2x_add': ('upsample2x_add_kernel', lambda s, ctx: upsample2x_add(s[0], s[1])),
    'hpe::upsample2x_add_bwd': ('upsample2x_add_bwd_kernel', lambda s, ctx: upsample2x_add_bwd(s[0])),
    'hpe::maxpool2x2_fwd': ('maxpool2x2_fwd_kernel', lambda s, ctx: maxpool2x2_fwd(s[0])),
    'hpe::maxpool2x2_bwd_first': ('maxpool2x2_bwd_kernel', lambda s, ctx: maxpool2x2_bwd(s[0], s[1])),
    'hpe::maxpool2x2_bwd': ('maxpool2x2_bwd_kernel', lambda s, ctx: maxpool2x2_bwd(s[0], s[1])),
    'hpe::render_gaussian': ('render_gaussian_kernel',
                             lambda s, ctx: render_gaussian(s[0], s[1], ctx['out_hw'])),
    'hpe::decode_peaks': ('decode_peaks_kernel', lambda s, ctx: decode_peaks(s[0])),
}


def bound_s(flops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the bandwidth (every port kernel
    that computes products computes them in bf16)."""
    return max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_S)
