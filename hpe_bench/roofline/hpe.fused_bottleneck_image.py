"""hpe::fused_bottleneck_image: the fused bottleneck, a block an image."""

from hpe_bench import kernels

SYMBOL = 'bottleneck_image_kernel'


def cost(shapes, ctx):
    return kernels.bottleneck(shapes[0])
