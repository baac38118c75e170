"""hpe::upsample2x_add_bwd: g [B, 2h, 2w, C] bf16 -> its 2x2 sums
[B, h, w, C]."""

from hpe_bench.kernels import BF16, numel

SYMBOL = 'upsample2x_add_bwd_kernel'


def cost(shapes, ctx):
    g = shapes[0]
    return 3 * numel(g) // 4, (numel(g) + numel(g) // 4) * BF16
