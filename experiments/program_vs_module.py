#!/usr/bin/env python3
"""Experiment: the exported serving program against the in-process
function, on one card.

    python3 experiments/program_vs_module.py [--batch 64] [--out FILE]

Builds the flagship serving function (`export.make_inference_fn` of the
8-stack hourglass, seeded weights, folded BN, bf16 weights, uint8 256^2
frames, the quarter decode, the kernels on), exports the same function
with `export.export_program` at the static batch and loads it back with
`load_program`. Then:

  * the graph: its nodes by target, and every node that sets a layout or
    a device (clone, contiguous, to.device, _to_copy, empty, full, zeros);
  * the times of a call, p50 of 10 after 3, in the order module, program,
    program, module, each one's time to return without a synchronize, and
    what the caching allocator did meanwhile (segments allocated and
    freed, retries);
  * a `torch.profiler` trace of one call of each: the device's busy time
    and the 12 kernels that take the most of it, the host's time in the
    CUDA runtime calls that wait (synchronize, memcpy), and the 15 host
    operations with the most self time.

Prints the card's name and power limit and one JSON line; writes it to
--out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

RES = 256
LAYOUT = ('clone', 'contiguous', 'to.device', '_to_copy', 'empty', 'full', 'zeros', 'copy')


def p50(fn, x, n: int = 10, warmup: int = 3):
    import torch
    done, back = [], []
    before = torch.cuda.memory_stats()
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i >= warmup:
            done.append((time.perf_counter() - t0) * 1e3)
            back.append((t1 - t0) * 1e3)
    after = torch.cuda.memory_stats()
    grew = {k: after[k] - before.get(k, 0) for k in (
        'num_alloc_retries', 'segment.all.allocated', 'segment.all.freed', 'num_device_alloc',
        'num_device_free') if k in after}
    return statistics.median(done), statistics.median(back), grew


def trace(fn, x) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    ev = [e for e in avgs if e.device_type == DeviceType.CUDA and e.device_time_total > 0
          and not getattr(e, 'is_user_annotation', False)]
    ev.sort(key=lambda e: -e.device_time_total)
    waits = {e.key: e.self_cpu_time_total / 1e3 for e in avgs
             if e.key.startswith('cuda') and any(k in e.key for k in ('Synchronize', 'Memcpy'))}
    host = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return dict(device_busy_ms=sum(e.device_time_total for e in ev) / 1e3,
                kernels=[(e.key[:80], e.count, e.device_time_total / 1e3) for e in ev[:12]],
                waits_ms=waits,
                host_self_ms=[(e.key[:60], e.count, e.self_cpu_time_total / 1e3)
                              for e in host[:15]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    from hourglass_pose_estimation_torch.data import get_meanstd
    from hourglass_pose_estimation_torch.export import (
        export_program, load_program, make_inference_fn)
    from hourglass_pose_estimation_torch.models import get_model
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    torch.manual_seed(0)
    model = get_model('hg', device='cpu', num_stacks=8, num_blocks=1, num_classes=16,
                      fuse_block=True, fuse_upsample=True)
    kw = dict(decode='quarter', fold_bn=True, weights_dtype=torch.bfloat16,
              preprocess=get_meanstd('mpii'), input_res=RES)
    frames = np.random.RandomState(0).randint(0, 256, (args.batch, RES, RES, 3)).astype(np.uint8)
    module = make_inference_fn(model, None, **kw)
    out = {'card': card, 'batch': args.batch}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = export_program(model, None, frames.shape, str(Path(tmp) / 'model.pt2'), **kw)
        out['export_s'] = time.perf_counter() - t0
        graph = torch.export.load(path).graph
        t0 = time.perf_counter()
        program = load_program(path)
        out['load_s'] = time.perf_counter() - t0
    calls = [n for n in graph.nodes if n.op == 'call_function']
    out['nodes'] = dict(collections.Counter(str(n.target) for n in calls).most_common())
    out['layout_nodes'] = [f'{n.target}{tuple(str(a)[:30] for a in n.args)} {n.kwargs}'
                           for n in calls if any(k in str(n.target) for k in LAYOUT)]
    out['equal'] = all(torch.equal(a, b) for a, b in zip(module(frames), program(frames)))
    times = collections.defaultdict(list)
    for name in ('module', 'program', 'program', 'module'):
        done, back, grew = p50(module if name == 'module' else program, frames)
        times[name + '_ms'].append(done)
        times[name + '_return_ms'].append(back)
        times[name + '_allocator'].append(grew)
    out.update(times)
    out['trace_module'] = trace(module, frames)
    out['trace_program'] = trace(program, frames)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
