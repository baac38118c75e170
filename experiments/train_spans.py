#!/usr/bin/env python3
"""Experiment: the train step's phase spans on the card, held against the
profiler's trace of the same steps.

    python3 experiments/train_spans.py --workload hg8-train-b64 --seed <n> [--seconds 5]

Runs the benchmark's train entry (`hpe_bench/entries/train.py`) on one
cell with its traced windows (the card's activity over a few steps, then
one step with every thread's CPU ops), keeps the profiler's
`record_function` ranges of each window, and prints one JSON line:

  * the five span readers, `train.device_idle` and `train.kernel_roofline`
    as a `--trace 1` run reads them, and the comparison's numbers;
  * per traced step, the five phases' device ms against the `train.step`
    span's own, and the `train.step` spans' device ms summed over the
    traced steps against the traced window;
  * each phase's mean host ms a step and the card's idle inside it (the
    part of its host interval with no kernel running), ms a step;
  * in each window, each span's host edges against its profiler range's:
    the count paired, the median and largest absolute offset in us.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PHASES = ('train.stage', 'train.forward', 'train.backward', 'train.optimizer', 'train.metrics')
READERS = ('train.stage_ms', 'train.forward_ms', 'train.backward_ms', 'train.optimizer_ms',
           'train.dispatch_idle', 'train.device_idle', 'train.kernel_roofline')


def edge_offsets(window: dict, records: list) -> dict:
    """Each span that opened inside the window paired with the profiler
    range of its name and rank among that name's: |start - start| and
    |end - end| in us."""
    mine = [s for s in records if window['t0'] <= s['start_ns'] <= window['t1']]
    offsets = []
    for name in {s['name'] for s in mine}:
        a = [s for s in mine if s['name'] == name]
        b = sorted(r for r in window['ranges'] if r[0] == name)
        for s, (_, r0, r1) in zip(a, b):
            offsets += [abs(s['start_ns'] - r0) / 1e3, abs(s['end_ns'] - r1) / 1e3]
    return {'spans': len(mine), 'ranges': len(window['ranges']), 'edges': len(offsets),
            'median_us': statistics.median(offsets) if offsets else None,
            'max_us': max(offsets) if offsets else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, default=5.0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from hpe_bench import harness, spans, trace
    from hpe_bench.run import Run
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print('train_spans: needs a CUDA card', file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    from hourglass_pose_estimation_torch.utils import tracing

    windows, reduce = [], trace.reduce

    def keep(events, t0_ns, t1_ns, device):
        # the host-side ranges that the program's spans opened
        ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                  if e.is_user_annotation() and e.name().startswith('train.')
                  and not str(e.device_type()).endswith('CUDA')]
        windows.append({'t0': t0_ns, 't1': t1_ns, 'ranges': ranges})
        return reduce(events, t0_ns, t1_ns, device)
    trace.reduce = keep

    cell = harness.load_cell(args.workload)
    out = harness.entry(cell['entry']).run(
        Run(cell, args.seed, args.seconds, True, 'cuda:0', time.time()))
    tr, records = out['trace'], tracing.spans()
    win = spans.in_window(tr, records)
    steps = sorted({s['step'] for s in win})
    per_step = []
    for st in steps:
        mine = [s for s in win if s['step'] == st]
        root = next(s for s in mine if s['name'] == 'train.step')
        phases = {s['name']: s['device_ms'] for s in mine if s['name'] in PHASES}
        per_step.append({'step': st, 'step_device_ms': root['device_ms'],
                         'step_host_ms': (root['end_ns'] - root['start_ns']) / 1e6,
                         'phases_device_ms': phases,
                         'phases_over_step': sum(phases.values()) / root['device_ms']
                         if root['device_ms'] else None})
    window_ms = (tr['hi'] - tr['lo']) / 1e6
    device_ms = [p['step_device_ms'] for p in per_step]
    host_ms = {p: sum(s['end_ns'] - s['start_ns'] for s in win if s['name'] == p)
               / 1e6 / len(steps) for p in PHASES}
    idle_ms = {p: spans.idle_inside_ns(tr, (p,), records) / 1e6 / len(steps) for p in PHASES}
    result = {
        'workload': args.workload, 'seed': args.seed, 'card': torch.cuda.get_device_name(0),
        'steps_in_window': out['attempted'], 'traced_steps': steps,
        'readers': {m: harness.metric_reader(m).read(out['ctx'], tr) for m in READERS},
        'numbers': out['numbers'], 'limits': cell['limits'],
        'per_step': per_step, 'window_ms': window_ms,
        'idle_ms_total': window_ms - tr['busy_s'] * 1e3,
        'step_spans_over_window': (sum(device_ms) / window_ms if None not in device_ms
                                   else None),
        'phase_host_ms': host_ms, 'phase_idle_ms': idle_ms,
        'clock': [edge_offsets(w, records) for w in windows],
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
