"""hpe::render_gaussian: mu [B, J, 2] int32, weight [B, J] f32 -> targets
[B, H, W, J] f32, (H, W) the context's `out_hw`."""

from hpe_bench.kernels import F32, I32, numel

SYMBOL = 'render_gaussian_kernel'


def cost(shapes, ctx):
    mu, weight = shapes[0], shapes[1]
    B, J = (int(d) for d in weight)
    out = B * int(ctx['out_hw'][0]) * int(ctx['out_hw'][1]) * J
    return 4 * out, numel(mu) * I32 + numel(weight) * F32 + out * F32
