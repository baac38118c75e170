"""hpe::maxpool2x2_fwd: x [B, H, W, C] bf16 -> [B, H/2, W/2, C]."""

from hpe_bench.kernels import BF16, numel

SYMBOL = 'maxpool2x2_fwd_kernel'


def cost(shapes, ctx):
    x = shapes[0]
    return 3 * numel(x) // 4, (numel(x) + numel(x) // 4) * BF16
