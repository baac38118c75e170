"""hpe::fused_bottleneck_chunked: the fused bottleneck over row chunks."""

from hpe_bench import kernels

SYMBOL = 'bottleneck_fwd_kernel'


def cost(shapes, ctx):
    return kernels.bottleneck(shapes[0])
