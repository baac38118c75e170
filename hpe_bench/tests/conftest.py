"""Shared helpers of the benchmark's own tests (CPU, tiny sizes)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str, **cfg_over):
    """Cell `name` cut to a CPU test's size: 2 stacks (or stages) at 128^2
    (64^2 leaves the hourglass's bottom at 1x1, whose batch statistics over
    a few values are too ill-conditioned to compare), batch 4. A key that
    the configuration's `model` also holds (MSPN's `out_res`) changes there
    too."""
    from hpe_bench import harness
    cell = harness.load_cell(name)
    cfg = cell['cfg']
    for k, v in {'num_stacks': 2, 'inp_res': 128, 'out_res': 32, **cfg_over}.items():
        cfg[k] = v
        if k in cfg['model']:
            cfg['model'][k] = v
    cell['mix'].update(batch=4, pool_batches=3, trace_steps=1)
    return cell


@pytest.fixture
def cpu_run():
    """execute(tiny cell) on the CPU, skipping the look for a card."""
    import time
    from hpe_bench import harness
    from hpe_bench.run import Run, execute

    def go(cell, seed=2 ** 33 + 11, seconds=1.0, trace=0):
        return execute(Run(cell, seed, seconds, trace, 'cpu', time.time()), harness.benchmark_spec())
    return go
