"""What the benchmark's processes load: never JAX or the JAX package, and
nothing of the program in the reference. Each check runs in a fresh
interpreter and compares each module's top-level name whole (the port's
name begins with the JAX package's)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from hpe_bench import harness

ROOT = harness.ROOT
TOPS = ('import sys, json; print(json.dumps(sorted({m.split(".", 1)[0] '
        'for m in list(sys.modules)})))')


def loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop('JAX_PLATFORMS', None)
    out = subprocess.run([sys.executable, '-c', code + '\n' + TOPS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


TINY = '''
import sys, time
sys.path.insert(0, "hpe_bench/tests")
from conftest import tiny_cell
from hpe_bench import harness
from hpe_bench.run import Run, execute
cell = tiny_cell({cell!r}, compute_dtype="float32")
execute(Run(cell, 12345, 0.5, {trace}, "cpu", time.time()), harness.benchmark_spec())
'''


@pytest.mark.parametrize('cell, trace', [('hg8-train-b256', 1), ('mspn2-train-b384', 0)])
def test_a_run_loads_no_jax(cell, trace):
    """A whole run of a cell (harness, program, reference, and with
    `--trace 1` the trace), at a tiny size on the CPU."""
    tops = loaded(TINY.format(cell=cell, trace=trace))
    assert 'hourglass_pose_estimation_torch' in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_every_benchmark_module_imports_without_jax():
    mods = ['hpe_bench.run', 'hpe_bench.calibrate', 'hpe_bench.trace', 'hpe_bench.stats']
    code = 'import importlib\n' + '\n'.join(f'importlib.import_module({m!r})' for m in mods)
    code += ('\nfrom hpe_bench import harness\n'
             'for p in sorted((harness.BENCH_DIR / "entries").glob("*.py")): harness.entry(p.stem)\n'
             'for p in sorted((harness.BENCH_DIR / "metrics").glob("*.py")): '
             'harness.metric_reader(p.stem)\n')
    assert not loaded(code) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = '''
import torch
from hpe_bench.reference import hourglass, mspn, pipeline, train
from hpe_bench import harness, synth
for name in ("hg8-mpii", "mspn2-mpii"):
    cfg = harness.read_json(harness.BENCH_DIR / "configs" / f"{name}.json")
    cfg.update(num_stacks=1, inp_res=128, out_res=32)
    m = train.build(cfg, "cpu")
    m(torch.randn(2, 128, 128, 3), train=True)
'''
    tops = loaded(code)
    assert not tops & (set(harness.FORBIDDEN) | {'hourglass_pose_estimation_torch'}), tops


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    """Here there is no CUDA card; in a directory holding only
    BENCHMARK.json and the benchmark's files (no program) too."""
    cmd = [sys.executable, 'hpe_bench/run.py', '--workload', 'hg8-train-b256', '--seed',
           str(2 ** 31 + 3), '--seconds', '1', '--trace', '0']
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(ROOT / 'hpe_bench', tmp_path / 'hpe_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout, out.stdout
