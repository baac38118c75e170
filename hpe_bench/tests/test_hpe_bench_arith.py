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


def test_a_failed_request_counts_as_infinite():
    lat = [10.0] * 94 + [math.inf] * 6
    assert stats.percentile(lat, 50) == 10.0
    assert stats.percentile(lat, 95) == math.inf
    assert stats.percentile(lat[:95] + [10.0] * 5, 95) == 10.0
