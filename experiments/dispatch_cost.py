#!/usr/bin/env python3
"""Experiment: the host cost of the kernels' binding, in two checkouts of
the repository on one card.

    python3 experiments/dispatch_cost.py TREE [TREE ...] [--rounds N] [--out FILE]

Each TREE is the root of a checkout (this one, or one unpacked with
`git archive` into the ignored `checkouts/`). Every round runs each tree
in a fresh process, in the order given and then reversed (A B B A for
two trees and one round), and each process measures on the card, with the
package of its own tree:

  * `serve_batch1_ms` and `serve_batch64_ms`: the flagship serving
    function (`export.make_inference_fn` of the 8-stack hourglass, seeded
    weights, folded BN, bf16 weights, uint8 256^2 frames, the quarter
    decode, the kernels on), the median of 30 synchronized calls at batch
    1 and of 10 at batch 64, after 3 untimed ones;
  * `serve_batch64_return_ms`: the time a batch-64 call takes to return,
    without a synchronize (its host time, and any wait for the card in it),
    the median of 7;
  * `train_step_ms`: the flagship train step (bench.py's build, batch 64),
    the median of 10 steps after 3;
  * `serve_batch64_syncs`: where one batch-64 call synchronizes with the
    card (file:line of each synchronizing CUDA call, and how often; from
    `torch.cuda.set_sync_debug_mode('warn')`);
  * `pool_call_us`: the host time of one call of `maxpool2x2_fwd` on a
    [1, 16, 16, 256] bf16 tensor, the mean of 2000 calls queued without a
    synchronize (the kernel itself takes a few microseconds, so the host's
    time per call bounds the loop).

The trees' kernel sources must be the same: the first tree builds them,
and its library is copied into the others' build directories. Prints the
card's name and power limit and one JSON line (every reading of every
tree); writes it to --out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

BATCH, RES = 64, 256
BUILD = Path('hourglass_pose_estimation_torch') / 'ops' / 'hopper' / 'build'


def median_ms(fn, n: int, warmup: int = 3) -> float:
    import torch
    times = []
    for i in range(warmup + n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[warmup:])


def measure(tree: str) -> dict:
    """The readings of one tree, in this process."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    from hourglass_pose_estimation_torch.data import Synthetic, get_meanstd, make_spec
    from hourglass_pose_estimation_torch.export import make_inference_fn
    from hourglass_pose_estimation_torch.models import get_model
    from hourglass_pose_estimation_torch.ops.hopper import maxpool2x2_fwd
    from hourglass_pose_estimation_torch.runner import (
        init_state, make_optimizer, make_train_step)
    import hourglass_pose_estimation_torch
    assert Path(hourglass_pose_estimation_torch.__file__).is_relative_to(Path(tree).resolve())
    kw = dict(num_stacks=8, num_blocks=1, num_classes=16, mobile=False, skip_mode='sum',
              fuse_block=True, fuse_upsample=True)
    torch.manual_seed(0)
    fn = make_inference_fn(get_model('hg', device='cuda', **kw), None, decode='quarter',
                           fold_bn=True, weights_dtype=torch.bfloat16,
                           preprocess=get_meanstd('mpii'), input_res=RES)
    frames = np.random.RandomState(0).randint(0, 256, (BATCH, RES, RES, 3)).astype(np.uint8)
    out = {'serve_batch1_ms': median_ms(lambda: fn(frames[:1]), 30),
           'serve_batch64_ms': median_ms(lambda: fn(frames), 10)}
    returns = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(frames)
        returns.append((time.perf_counter() - t0) * 1e3)
    out['serve_batch64_return_ms'] = statistics.median(returns)
    # where one batch-64 call waits for the card: PyTorch warns at every
    # synchronizing CUDA call in this mode
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        fn(frames)
        torch.cuda.set_sync_debug_mode('default')
    syncs = collections.Counter(f'{Path(w.filename).name}:{w.lineno}' for w in caught
                                if 'synchroniz' in str(w.message))
    out['serve_batch64_syncs'] = dict(syncs)
    del fn
    ds = Synthetic(True, num_samples=BATCH, inp_res=RES, out_res=RES // 4, sigma=1,
                   scale_factor=0.25, rot_factor=30)
    raw, spec = ds.canvas_batch(range(BATCH), canvas=RES), make_spec(ds)
    torch.manual_seed(0)
    box = {'state': init_state(get_model('hg', device='cuda', **kw),
                               make_optimizer(2.5e-3, [35, 45], 0.1, 100))}
    step = make_train_step(spec, device_pipeline=True)

    def train():
        box['state'], m = step(box['state'], raw, 0)
        float(m['loss'])

    out['train_step_ms'] = median_ms(train, 10)
    x = torch.randn(1, 16, 16, 256, device='cuda').to(torch.bfloat16)
    for _ in range(100):
        maxpool2x2_fwd(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        maxpool2x2_fwd(x)
    out['pool_call_us'] = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('trees', nargs='+')
    ap.add_argument('--rounds', type=int, default=1)
    ap.add_argument('--out', default=None)
    ap.add_argument('--measure', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.trees[0])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    trees = [str(Path(t).resolve()) for t in args.trees]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-c', 'from hourglass_pose_estimation_torch.ops.hopper '
                        'import _build; print(_build.build()[0])'], cwd=trees[0],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    built = Path(r.stdout.strip().splitlines()[-1])
    for t in trees[1:]:
        (Path(t) / BUILD).mkdir(parents=True, exist_ok=True)
        for f in (built, built.with_suffix('.log')):        # the library and its build log
            shutil.copy2(f, Path(t) / BUILD / f.name)
    print(f'build {time.perf_counter() - t0:.1f} s: {built.name}', flush=True)
    out = {'card': card, 'trees': trees, 'runs': []}
    order = [t for _ in range(args.rounds) for t in trees + trees[::-1]]
    for tree in order:
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), tree, '--measure'],
                           cwd=tree, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-3000:] + r.stderr[-3000:], file=sys.stderr)
            return 1
        reading = json.loads(r.stdout.strip().splitlines()[-1])
        print(f'{tree}: {json.dumps(reading)}', flush=True)
        out['runs'].append(dict(tree=tree, **reading))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
