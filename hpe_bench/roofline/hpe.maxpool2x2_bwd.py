"""hpe::maxpool2x2_bwd: the pool's backward, a tie's gradient split."""

from hpe_bench import kernels

SYMBOL = 'maxpool2x2_bwd_kernel'


def cost(shapes, ctx):
    return kernels.maxpool2x2_bwd(shapes[0], shapes[1])
