"""The benchmark's own arithmetic: model FLOPs, the kernels' bounds, the
percentiles."""

import math

import pytest

from hpe_bench import flops, harness, kernels, stats


@pytest.mark.parametrize('config, gflop', [('hg8-mpii', 56.2), ('mspn2-mpii', 30.0)])
def test_forward_flops_of_the_configurations(config, gflop):
    cfg = harness.read_json(harness.BENCH_DIR / 'configs' / f'{config}.json')
    got = flops.forward_flops(cfg)
    assert abs(got / 1e9 - gflop) < 0.05, got
    assert flops.train_flops(cfg) == 3 * got


@pytest.mark.parametrize('op, shapes, bound_ms', [
    ('hpe::fused_bottleneck_chunked', [[64, 64, 64, 256]], 0.1129),
    ('hpe::upsample2x_add', [[64, 32, 32, 256], [64, 64, 64, 256]], 0.0901),
    ('hpe::upsample2x_add_bwd', [[64, 64, 64, 256]], 0.0501),
    ('hpe::maxpool2x2_fwd', [[64, 64, 64, 256]], 0.0501),
    ('hpe::maxpool2x2_bwd_first', [[64, 64, 64, 256], [64, 32, 32, 256]], 0.0901),
    ('hpe::render_gaussian', [[64, 16, 2], [64, 16], []], 0.00501),
    ('hpe::decode_peaks', [[64, 64, 64, 16]], 0.00501),
])
def test_kernel_bounds_match_the_kernel_table(op, shapes, bound_ms):
    """The bounds of PERF.md's kernel table at its shapes, to its digits."""
    f, b = kernels.KERNELS[op][1](shapes, {'out_hw': (64, 64)})
    got = kernels.bound_s(f, b) * 1e3
    assert round(got, 4 if bound_ms > 0.01 else 5) == bound_ms, got


# op: (symbol, its shapes, (flops, bytes)) as the one table of kernels.py
# gave them before each kernel's cost became a file of `roofline/`
TABLE = {
    'hpe::fused_bottleneck_chunked': ('bottleneck_fwd_kernel', [[64, 64, 64, 256]],
                                      (111669149696, 268866560)),
    'hpe::fused_bottleneck_image': ('bottleneck_image_kernel', [[64, 64, 64, 256]],
                                    (111669149696, 268866560)),
    'hpe::upsample2x_add': ('upsample2x_add_kernel', [[64, 32, 32, 256], [64, 64, 64, 256]],
                            (67108864, 301989888)),
    'hpe::upsample2x_add_bwd': ('upsample2x_add_bwd_kernel', [[64, 64, 64, 256]],
                                (50331648, 167772160)),
    'hpe::maxpool2x2_fwd': ('maxpool2x2_fwd_kernel', [[64, 64, 64, 256]], (50331648, 167772160)),
    'hpe::maxpool2x2_bwd_first': ('maxpool2x2_bwd_kernel', [[64, 64, 64, 256], [64, 32, 32, 256]],
                                  (67108864, 301989888)),
    'hpe::maxpool2x2_bwd': ('maxpool2x2_bwd_kernel', [[64, 64, 64, 256], [64, 32, 32, 256]],
                            (67108864, 301989888)),
    'hpe::render_gaussian': ('render_gaussian_kernel', [[64, 16, 2], [64, 16], []],
                             (16777216, 16789504)),
    'hpe::decode_peaks': ('decode_peaks_kernel', [[64, 64, 64, 16]], (4194304, 16789504)),
}


def test_the_kernel_files_are_the_nine_ops():
    assert set(kernels.KERNELS) == set(TABLE)


@pytest.mark.parametrize('op', sorted(TABLE))
def test_each_kernel_file_keeps_its_symbol_and_cost(op):
    symbol, shapes, cost = TABLE[op]
    got_symbol, fn = kernels.KERNELS[op]
    assert got_symbol == symbol
    assert fn(shapes, {'out_hw': (64, 64)}) == cost


def test_a_failed_request_counts_as_infinite():
    lat = [10.0] * 94 + [math.inf] * 6
    assert stats.percentile(lat, 50) == 10.0
    assert stats.percentile(lat, 95) == math.inf
    assert stats.percentile(lat[:95] + [10.0] * 5, 95) == 10.0
