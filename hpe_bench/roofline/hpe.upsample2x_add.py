"""hpe::upsample2x_add: low [B, h, w, C] and skip [B, 2h, 2w, C] bf16 ->
[B, 2h, 2w, C]."""

from hpe_bench.kernels import BF16, numel

SYMBOL = 'upsample2x_add_kernel'


def cost(shapes, ctx):
    low, skip = shapes[0], shapes[1]
    return numel(skip), (numel(low) + 2 * numel(skip)) * BF16
