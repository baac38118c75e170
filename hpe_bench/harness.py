"""What every run of the benchmark shares: finding a cell's files by name,
the cache directories, the result line, the checks' printout and the
look for JAX in the process.

A cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`), the
entry that drives it (`entries/<entry>.py`) and the chips it needs. A
configuration file names its plain reference (`reference`, a module file
whose `build(cfg, checkpointed)` makes the model) and carries the keyword
arguments of the program's model (`model`); each port kernel's cost is
`roofline/<op>.py`. The metrics a cell reports are the ones
`BENCHMARK.json` gives it: every end-to-end metric whose `workloads` lists
it (or that has no such list), and with `--trace 1` every per-layer metric
that lists it. A per-layer metric is read under the longest dotted prefix
of its name that has a reader: `train.step_mfu.hg8` by
`metrics/train.step_mfu.hg8.py` if there is one, else by
`metrics/train.step_mfu.py`; an end-to-end metric is the entry's value of
the same name. Nothing here names a cell, a configuration, a kernel or a
metric: a later cell or configuration is new files and entries appended to
`BENCHMARK.json`'s lists.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hourglass_pose_estimation_tpu')


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell `name` with its configuration and traffic mix read in:
    {'name', 'config', 'traffic', 'entry', 'chips', 'why', 'cfg': {...},
    'mix': {...}}. A missing file raises FileNotFoundError."""
    cell = read_json(BENCH_DIR / 'workloads' / f'{name}.json')
    cell['name'] = name
    cell['cfg'] = read_json(BENCH_DIR / 'configs' / f"{cell['config']}.json")
    cell['mix'] = read_json(BENCH_DIR / 'traffic' / f"{cell['traffic']}.json")
    return cell


def benchmark_spec() -> dict:
    return read_json(ROOT / 'BENCHMARK.json')


def metrics_of(name: str, spec: dict, trace: bool) -> list:
    """The metrics entries of `BENCHMARK.json` that cell `name` reports in
    a run with `trace` off (end-to-end) or on (per-layer)."""
    e2e = [m for m in spec['end_to_end'] if name in m.get('workloads', [name])]
    if not trace:
        return e2e
    moved = {m['name'] for m in e2e}
    return [m for m in spec['per_layer']
            if (name in m['workloads'] if 'workloads' in m else m['moves'] in moved)]


def load_module(path: Path, name: str):
    """The Python file at `path` as a module (names with dots need this)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(name: str):
    return load_module(BENCH_DIR / 'entries' / f'{name}.py', f'hpe_bench_entry_{name}')


def longest_prefix(name: str, has) -> str | None:
    """The longest dotted prefix of `name`, `name` itself first, for which
    `has(prefix)` holds (None if none does)."""
    parts = name.split('.')
    return next((p for p in ('.'.join(parts[:k]) for k in range(len(parts), 0, -1)) if has(p)),
                None)


def metric_reader(name: str):
    """The reader of per-layer metric `name` (see the module docstring)."""
    found = longest_prefix(name, lambda p: (BENCH_DIR / 'metrics' / f'{p}.py').is_file())
    if found is None:
        raise FileNotFoundError(f'no reader in metrics/ for {name!r}')
    return load_module(BENCH_DIR / 'metrics' / f'{found}.py',
                       'hpe_bench_metric_' + found.replace('.', '_').replace('-', '_'))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program builds its CUDA library into its own `ops/hopper/build/`, which
    lies there too)."""
    cache = ROOT / '.bench_cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(cache / 'nv_compute')
    os.environ.setdefault('USE_FLAX', '0')
    os.environ.setdefault('USE_JAX', '0')


def forbidden_loaded() -> list:
    """Forbidden top-level module names that `sys.modules` holds, compared
    whole (the port's name begins with the JAX package's)."""
    tops = {m.split('.', 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def check(value: float, limit: float) -> dict:
    """One number compared, beside its limit."""
    return {'value': value, 'limit': limit}


def checks_pass(checks: dict) -> bool:
    """Every number finite and at or under its limit."""
    return all(isinstance(c['value'], (int, float)) and math.isfinite(c['value'])
               and c['value'] <= c['limit'] for c in checks.values())


def print_checks(checks: dict) -> None:
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
