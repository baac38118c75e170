"""hpe::decode_peaks: heatmaps [B, H, W, J] f32 -> coords [B, J, 2] and
maxvals [B, J]."""

from hpe_bench.kernels import F32, numel

SYMBOL = 'decode_peaks_kernel'


def cost(shapes, ctx):
    hm = shapes[0]
    B, H, W, J = (int(d) for d in hm)
    return numel(hm), (numel(hm) + 3 * B * J) * F32
