#!/usr/bin/env python3
"""Experiment: what DistributedDataParallel costs the flagship train step
at world size 1 on one card, and where.

    python3 experiments/ddp_cost.py [--steps N] [--out FILE]

One process forms a process group of itself (NCCL, world size 1) and runs
chip_smoke's flagship train step (the 8-stack hourglass, bf16, batch 64,
RMSprop at 2.5e-3, the kernels on) from the same seeded weights in three
states, in turns (plain, ddp, ddp_view, ddp_view, ddp, plain, ...):

  * `plain`: `make_train_step(spec)`, no mesh;
  * `ddp`: `make_train_step(spec, mesh=make_mesh())`, the Trainer's
    implicit path (DistributedDataParallel with its defaults and the
    buffers left as they are);
  * `ddp_view`: the same with `gradient_as_bucket_view=True` (the
    gradients are views into DDP's buckets: no copy back after the
    all-reduce).

For each: the step's ms p50 over N steps after 2 (host clock to the read
of the loss), and a torch.profiler trace of one step: device busy ms (the
sum of the card's kernel times, without the card-side annotations of host
ranges), the host's busy ms and the ops with the
most host time (self) and the most device time, and the number of kernel
launches. Prints the card's name and power limit and one JSON line;
writes it to --out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def profile_step(run) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = lambda e: getattr(e, 'self_device_time_total', getattr(e, 'self_cuda_time_total', 0))
    host = [e for e in events if e.device_type.name == 'CPU']
    # the card's side of a host range (DDP's forward records one) is an
    # annotation over kernels counted on their own, not a kernel
    ranges = {e.key for e in host}
    kernels = [e for e in events if e.device_type.name == 'CUDA' and e.key not in ranges]
    top = lambda evs, key, n: [(e.key[:80], round(key(e) / 1e3, 3), e.count)
                               for e in sorted(evs, key=key, reverse=True)[:n]]
    return dict(device_busy_ms=sum(dev(e) for e in kernels) / 1e3,
                kernel_launches=sum(e.count for e in kernels),
                host_self_ms=sum(e.self_cpu_time_total for e in host) / 1e3,
                top_host_self_ms=top(host, lambda e: e.self_cpu_time_total, 14),
                top_device_ms=top(kernels, dev, 10))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--steps', type=int, default=6)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('ddp_cost: no CUDA device', file=sys.stderr)
        return 2
    from torch.nn.parallel import DistributedDataParallel as DDP
    import chip_smoke as cs
    from hourglass_pose_estimation_torch.parallel import (
        make_mesh, maybe_initialize_distributed, sync_batch_norm)
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(cs.free_port()))
    maybe_initialize_distributed('cuda', verbose=False)
    mesh = make_mesh()
    raw, spec = cs.train_data(cs.TRAIN_BATCH)
    tx = make_optimizer(*cs.OPT)
    model = sync_batch_norm(cs.flagship_model(0))
    states = {name: init_state(cs.copy.deepcopy(model), tx) for name in ('plain', 'ddp', 'ddp_view')}
    states['ddp_view'].ddp = DDP(states['ddp_view'].model, device_ids=[mesh.device.index],
                                 broadcast_buffers=False, gradient_as_bucket_view=True)
    steps = {'plain': make_train_step(spec), 'ddp': make_train_step(spec, mesh=mesh),
             'ddp_view': make_train_step(spec, mesh=mesh)}
    order = list(states)
    times = {k: [] for k in order}
    for i in range(2 + args.steps):
        for name in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            states[name], m = steps[name](states[name], raw, 0)
            float(m['loss'])
            if i >= 2:
                times[name].append((time.perf_counter() - t0) * 1e3)
    out = {'card': smi.stdout.strip(), 'batch': cs.TRAIN_BATCH, 'steps': args.steps}
    for name in order:
        out[name] = dict(step_ms_p50=sorted(times[name])[len(times[name]) // 2],
                         step_ms=times[name],
                         profile=profile_step(lambda: steps[name](states[name], raw, 0)))
    grads = lambda s: [p.grad for p in s.model.parameters()]
    out['grad_layouts_match_params'] = {
        name: all(g.stride() == p.stride() for g, p in zip(grads(states[name]),
                                                           states[name].model.parameters()))
        for name in order}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + '\n')
    torch.distributed.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
