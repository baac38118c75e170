"""The readings that a cell's limits are set from, on the card at the cell's
own size: the numbers compared, for sound runs of the program over many
seeds, for the control (the reference put in the program's place, its
convolutions in fp8, the precision below the configuration's bf16), and
for the faults a train cell can have; and the witnesses that say where a
gap comes from.

    python3 hpe_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --what program,control,half_batch [--set cfg.key=json ...]

A train cell needs no window: each seed builds the train state, runs the
traffic's first steps through the window's own call and compares them
with the reference. `half_batch` plants a fault under the same steps: the
program's step sees half of each batch (the mean taken over the rest). A
state left unchanged reads 1 on `change_gap` by its definition and needs
no run. The witnesses, each read against the f32 reference like the
program: `program_f32` (the program built in float32, TF32 off),
`reference_bf16` (the reference with bf16 convolutions) and
`reference_f64` (the reference in float64); with `reference_f64` asked
for, every other reading is also given against it (`vs_f64`). `--set`
changes a key of the configuration (`cfg.`) or the traffic (`mix.`) for
the readings, e.g. `--set cfg.bn_scale_of=null --set mix.batch=64`.
One JSON line a reading; the benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hpe_bench import harness  # noqa: E402

PROGRAM_READINGS = ('program', 'half_batch', 'program_f32')
REFERENCE_READINGS = {'control': 'fp8', 'reference_bf16': 'bf16', 'reference_f64': 'f64'}


@contextlib.contextmanager
def half_batch_steps():
    """While open, the program's train step sees the first half of each
    batch it is given."""
    from hourglass_pose_estimation_torch import runner
    real = runner.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def half(state, batch, rng):
            b = batch['canvas'].shape[0] // 2
            return step(state, {key: v[:b] for key, v in batch.items()}, rng)
        return half
    runner.make_train_step = make
    try:
        yield
    finally:
        runner.make_train_step = real


def program_readings(cell, seed, what, device):
    """The program's readings of its first steps (None: out of memory)."""
    import copy
    import torch
    from hpe_bench.entries import train as entry
    from hpe_bench.reference.layers import no_tf32
    from hpe_bench.run import Run
    cell = copy.deepcopy(cell)
    fault = half_batch_steps() if what == 'half_batch' else contextlib.nullcontext()
    if what == 'program_f32':
        cell['cfg']['compute_dtype'] = 'float32'
        no_tf32()
    try:
        with fault:
            state, step, pool, spec, weights, readings = entry.setup(
                Run(cell, seed, 0, False, device, time.time()))
    except torch.cuda.OutOfMemoryError:
        readings = None
    state = step = None
    torch.cuda.empty_cache()
    return readings


def train_readings(cell, seed, what, device):
    import torch
    from hpe_bench.entries import train as entry
    from hpe_bench.reference import train as reference
    cfg, mix = cell['cfg'], cell['mix']
    out = {w: program_readings(cell, seed, w, device) for w in what if w in PROGRAM_READINGS}
    _, weights = entry.program.build_model(cfg, seed, device)
    first = entry.make_pool(cfg, mix, seed, device, mix['pool_batches'],
                            mix['batch'])[:mix['first_steps']]
    spec = entry.spec_of(cfg, mix)
    torch.cuda.empty_cache()
    lr = mix['optimizer']['lr']
    ref = reference.first_steps(cfg, weights, first, seed, spec, lr)
    for w, precision in REFERENCE_READINGS.items():
        if w in what:
            out[w] = reference.first_steps(cfg, weights, first, seed, spec, lr, precision)
    got = {w: (reference.detail(rd, ref) if rd is not None else {'out_of_memory': True})
           for w, rd in out.items()}
    if 'reference_f64' in out:
        for w, rd in out.items():
            if w != 'reference_f64' and rd is not None:
                got[w]['vs_f64'] = {k: v for k, v in reference.detail(rd, out['reference_f64']).items()
                                    if k in reference.NUMBERS}
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--what', default='program')
    ap.add_argument('--set', action='append', default=[], metavar='cfg.key=json')
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print('calibrate: needs a CUDA card', file=sys.stderr)
        return 2
    what = args.what.split(',')
    for seed in (int(s) for s in args.seeds.split(',')):
        cell = harness.load_cell(args.workload)
        for item in args.set:
            key, value = item.split('=', 1)
            part, key = key.split('.', 1)
            cell[part][key] = json.loads(value)
        t = time.time()
        got = train_readings(cell, seed, what, 'cuda:0')
        for w, numbers in got.items():
            print(json.dumps({'workload': args.workload, 'seed': seed, 'what': w,
                              'set': args.set, 'numbers': numbers,
                              's': time.time() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
