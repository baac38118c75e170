#!/usr/bin/env python3
"""Experiment: where the two-stage pipeline step's time goes on one card.

    python3 experiments/pipeline_cost.py [--steps N] [--out FILE]

chip_smoke's phase 19(b) runs the flagship's 8 stacks split 4 + 4 over
two ranks on one card over gloo (bf16, global batch 32 in 4 microbatches
of 8). This script takes that step apart:

  1. in one process (no process group: one stage holding all 8 stacks, no
     hand-off, no collective), in turns: `plain`, the standard train step
     (`make_train_step`) at batch 32; `pipe_m1`, the pipelined step with
     one microbatch (the same work through the pipeline's code); `pipe_m4`,
     with 4 microbatches of 8 (what the microbatching alone costs);
  2. two ranks on this card over gloo, each a process of its own, phase
     19(b)'s step.

For each: the step's ms p50 over N steps after 2 (host clock to the read
of the loss; the two ranks' steps also give the hand-off's host ms), and
a torch.profiler trace of one step: device busy ms (the sum of the card's
kernel times), kernel launches, and for the ranks each one's own busy ms
(two processes time-slice the card: their busy times add up). Prints the
card's name and power limit and one JSON line; writes it to --out. Needs
a CUDA card and the kernels phase 2 of chip_smoke builds (built here if
missing).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

GLOBAL_BATCH, M = 32, 4
SEED = 0


def profile_step(run) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = lambda e: getattr(e, 'self_device_time_total', getattr(e, 'self_cuda_time_total', 0))
    ranges = {e.key for e in events if e.device_type.name == 'CPU'}
    kernels = [e for e in events if e.device_type.name == 'CUDA' and e.key not in ranges]
    top = [(e.key[:60], round(dev(e) / 1e3, 3), e.count)
           for e in sorted(kernels, key=dev, reverse=True)[:8]]
    return dict(profiled_wall_ms=wall * 1e3, device_busy_ms=sum(dev(e) for e in kernels) / 1e3,
                kernel_launches=sum(e.count for e in kernels), top_kernels=top)


def p50(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def one_process(steps: int) -> dict:
    """The standard step and the one-stage pipelined step, in turns."""
    import torch
    import chip_smoke as cs
    from hourglass_pose_estimation_torch.parallel import make_mesh
    from hourglass_pose_estimation_torch.parallel.pipeline import make_pipeline_train_step_raw
    from hourglass_pose_estimation_torch.runner import init_state, make_optimizer, make_train_step
    raw, spec = cs.train_data(GLOBAL_BATCH)
    mesh = make_mesh(0, 1, 'cuda')
    runs = {'plain': (init_state(cs.flagship_model(SEED), make_optimizer(*cs.DP_OPT)),
                      make_train_step(spec))}
    for m in (1, M):
        runs[f'pipe_m{m}'] = (cs.pp_stage(SEED, mesh),
                              make_pipeline_train_step_raw(spec, mesh, num_microbatches=m))
    times = {name: [] for name in runs}
    order = list(runs)
    for i in range(2 + steps):
        for name in (order if i % 2 else order[::-1]):
            state, step = runs[name]
            t0 = time.perf_counter()
            _, m = step(state, raw, SEED)
            float(m['loss'])
            if i >= 2:
                times[name].append(time.perf_counter() - t0)
    out = {}
    for name, (state, step) in runs.items():
        out[name] = dict(step_ms_p50=p50(times[name]) * 1e3,
                         step_ms=[t * 1e3 for t in times[name]],
                         profile=profile_step(lambda: float(step(state, raw, SEED)[1]['loss'])))
    return out


def rank(work: str, steps: int) -> int:
    """One of the two ranks of part 2 (a process of its own on cuda:0)."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from hourglass_pose_estimation_torch.parallel import make_mesh, maybe_initialize_distributed
    from hourglass_pose_estimation_torch.parallel.pipeline import make_pipeline_train_step_raw
    maybe_initialize_distributed('cuda:0', backend='gloo', timeout=600, verbose=False)
    mesh = make_mesh(0, 1, 'cuda:0', pipeline_parallel=2)
    raw, spec = cs.train_data(GLOBAL_BATCH)
    state = cs.pp_stage(SEED, mesh)
    step = make_pipeline_train_step_raw(spec, mesh, num_microbatches=M)
    times, handoff = [], []
    for i in range(2 + steps):
        t0 = time.perf_counter()
        _, m = step(state, raw, SEED)
        float(m['loss'])
        if i >= 2:
            times.append(time.perf_counter() - t0)
            handoff.append(m['handoff_s'])
    holder = {}

    def run():
        holder['m'] = step(state, raw, SEED)[1]
        float(holder['m']['loss'])
    prof = profile_step(run)
    out = dict(stage=mesh.stage, step_ms_p50=p50(times) * 1e3, step_ms=[t * 1e3 for t in times],
               handoff_ms_p50=p50(handoff) * 1e3, profiled_handoff_ms=holder['m']['handoff_s'] * 1e3,
               profile=prof, max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    (Path(work) / f'rank{mesh.stage}.json').write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def two_ranks(steps: int) -> dict:
    with tempfile.TemporaryDirectory() as work:
        import chip_smoke as cs
        env = dict(os.environ, WORLD_SIZE='2', MASTER_ADDR='127.0.0.1',
                   MASTER_PORT=str(cs.free_port()))
        here = str(Path(__file__).resolve().parent)
        procs, logs = [], []
        for r in range(2):
            logs.append(Path(work) / f'rank{r}.log')
            with open(logs[-1], 'wb') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, '-c', f'import sys; sys.path.insert(0, {here!r}); '
                     f'import pipeline_cost; sys.exit(pipeline_cost.rank({work!r}, {steps}))'],
                    cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                    stderr=subprocess.STDOUT))
        cs.wait_ranks(procs, logs, 900)
        return {f'stage{r}': json.loads((Path(work) / f'rank{r}.json').read_text())
                for r in range(2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--steps', type=int, default=8)
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('pipeline_cost: no CUDA device', file=sys.stderr)
        return 2
    from hourglass_pose_estimation_torch.ops.hopper import _build
    _build.library()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = dict(card=card, global_batch=GLOBAL_BATCH, microbatches=M, steps=args.steps,
               one_process=one_process(args.steps))
    torch.cuda.empty_cache()
    out['two_ranks'] = two_ranks(args.steps)
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line)
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
