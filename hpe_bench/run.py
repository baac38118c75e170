"""One run of one benchmark cell on the card, as one JSON line.

    python3 hpe_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the interpreter's start to the first timed step or request)
is `setup_s`; the window then runs `--seconds`. With `--trace 0` the line
holds the cell's end-to-end metrics, with `--trace 1` its per-layer ones.
After the window the output is compared with the plain reference
(`reference/`), each number beside its limit, and `correct` says whether
every one is within it. Without a CUDA card, or with fewer cards than the
cell needs, the run exits non-zero and prints no result.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hpe_bench import harness  # noqa: E402


class Run:
    """One run's arguments, as the entries read them."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: str,
                 t0: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t0 = bool(trace), device, t0


def execute(run: Run, spec: dict) -> dict:
    """Drive the cell's entry and reduce what it returns to the result line
    (no look for a card here: `main` makes it, tests skip it)."""
    name = run.cell['name']
    out = harness.entry(run.cell['entry']).run(run)
    limits = run.cell['limits']
    # a number the cell has no limit for is not compared (PERF.md says why)
    checks = {k: harness.check(out['numbers'][k], v) for k, v in limits.items()}
    for k, v in out['numbers'].items():
        if k not in limits:
            print(f'not compared {k}: {v!r}', file=sys.stderr, flush=True)
    metrics = {}
    for m in harness.metrics_of(name, spec, run.trace):
        if run.trace:
            value = harness.metric_reader(m['name']).read(out['ctx'], out['trace'])
        else:
            value = out['setup_s'] if m['name'] == 'setup_s' else out['e2e'].get(m['name'])
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {
        'correct': harness.checks_pass(checks) and out['failed'] == 0,
        'attempted': out['attempted'], 'failed': out['failed'], 'metrics': metrics,
        'device': device_info(run.device, out),
    }
    if run.trace and out['trace'] is not None:
        from hpe_bench.trace import breakdown
        result['device'].update(busy_s=out['trace']['busy_s'], window_s=out['trace']['window_s'])
        result['breakdown'] = breakdown(out['trace'])
    result['checks'] = checks
    return result


def device_info(device: str, out: dict) -> dict:
    import torch
    dev = torch.device(device)
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': out['count'],
                'memory_peak_bytes': out['memory_peak_bytes']}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev), 'count': out['count'],
            'memory_peak_bytes': out['memory_peak_bytes']}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    spec = harness.benchmark_spec()

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'hpe_bench: the cell needs {cell["chips"]} CUDA card(s); this machine has {have}',
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = execute(Run(cell, args.seed, args.seconds, args.trace, 'cuda:0', T0), spec)
    found = harness.forbidden_loaded()
    if found:
        print(f'hpe_bench: the process loaded {found}', file=sys.stderr)
        return 3
    harness.print_checks(result['checks'])
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
