"""Operations and bytes of one launch of each of the port's kernels, from its
shapes, and the roofline bound that follows.

Each kernel is a file of its own, `roofline/<op>.py`, named after the
`torch.library` op that launches it with its `::` written as a dot
(`hpe::upsample2x_add` is `roofline/hpe.upsample2x_add.py`). The file
defines `SYMBOL`, the substring the kernel's CUDA symbol carries in a device
trace, and `cost(shapes, ctx) -> (flops, bytes)` from the op's input shapes
(and the run's context, `ctx`). `KERNELS` maps each op to (`SYMBOL`,
`cost`), so a new kernel is a new file. Each input byte is counted once as
read and each output byte once as written, whatever the kernel reads again.
"""

from __future__ import annotations

import math

from hpe_bench import harness
from hpe_bench.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_S

BF16, F32, I32 = 2, 4, 4


def numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def bottleneck(x, planes: int = 128):
    """x [B, H, W, 2*planes] bf16 -> the same: 1x1 (2P -> P), 3x3 (P -> P),
    1x1 (P -> 2P) products, and x read, the folded weights read, out
    written (both of the fused bottleneck's kernels)."""
    B, H, W, C = (int(d) for d in x)
    P = planes
    flops = 2 * B * H * W * (C * P + 9 * P * P + P * C)
    weights = (C * P + 9 * P * P + P * C) * BF16 + (3 * P + C) * F32 * 2
    return flops, 2 * numel(x) * BF16 + weights


def maxpool2x2_bwd(x, g):
    """x [B, H, W, C] and g [B, H/2, W/2, C] bf16 -> dx [B, H, W, C] (both
    of the pool's backward kernels)."""
    return numel(x), (2 * numel(x) + numel(g)) * BF16


def bound_s(flops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the bandwidth (every port kernel
    that computes products computes them in bf16)."""
    return max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_S)


def _load_table() -> dict:
    """op name -> (substring of the kernel's symbol, cost(shapes, ctx))."""
    table = {}
    for path in sorted((harness.BENCH_DIR / 'roofline').glob('*.py')):
        module = harness.load_module(path, 'hpe_bench_roofline_' + path.stem.replace('.', '_'))
        table[path.stem.replace('.', '::', 1)] = (module.SYMBOL, module.cost)
    return table


# built last: the files import the helpers above
KERNELS = _load_table()
