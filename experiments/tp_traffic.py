#!/usr/bin/env python3
"""Experiment: the model axis's traffic of one tensor-parallel train step,
counted on the CPU.

    python3 experiments/tp_traffic.py [--res 256] [--stacks 1 2] [--batch 1]

Starts two gloo ranks on the CPU (each a process of its own, a data 1 x
model 2 layout) and runs one train step of the hourglass (bf16, 128
features, the device pipeline) for each stack count, counting what
`parallel/tensor_parallel.py`'s collectives move (`TRAFFIC`: calls, and
the bytes of their results on a rank). The counts depend on the shapes
only, not on the device, so two stack counts give the stem's share and a
stack's, and from them the flagship's (8 stacks) at any batch: bytes scale
with the batch, the calls do not. Prints one JSON line. No time is
measured here: the counts only.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def rank_main(args) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    from hourglass_pose_estimation_torch.data import Synthetic, make_spec
    from hourglass_pose_estimation_torch.models import get_model
    from hourglass_pose_estimation_torch.parallel import (
        ShardedTrainState, make_mesh, maybe_initialize_distributed)
    from hourglass_pose_estimation_torch.parallel import tensor_parallel as tpl
    from hourglass_pose_estimation_torch.runner import make_optimizer, make_train_step
    torch.set_num_threads(2)
    maybe_initialize_distributed('cpu', verbose=False)
    mesh = make_mesh(1, 2, 'cpu')
    ds = Synthetic(True, num_samples=args.batch, inp_res=args.res, out_res=args.res // 4,
                   sigma=1, scale_factor=0.25, rot_factor=30)
    raw, spec = ds.canvas_batch(range(args.batch), canvas=args.res), make_spec(ds)
    counts = {}
    for stacks in args.stacks:
        torch.manual_seed(0)
        model = get_model('hg', device='cpu', num_stacks=stacks, num_classes=16,
                          dtype=torch.bfloat16)
        state = ShardedTrainState.create(model, make_optimizer(2.5e-5, [], 0.1, 10), mesh)
        tpl.TRAFFIC.reset()
        make_train_step(spec, mesh=mesh)(state, raw, 0)
        counts[stacks] = dict(calls=tpl.TRAFFIC.calls, bytes=tpl.TRAFFIC.bytes)
    if mesh.model_rank == 0:
        a, b = args.stacks[0], args.stacks[-1]
        per_stack = {k: (counts[b][k] - counts[a][k]) / (b - a) for k in ('calls', 'bytes')}
        stem = {k: counts[a][k] - a * per_stack[k] for k in per_stack}
        flagship = {k: stem[k] + 8 * per_stack[k] for k in per_stack}
        print(json.dumps(dict(res=args.res, batch=args.batch, counts=counts, stem=stem,
                              per_stack=per_stack, flagship_8_stacks=flagship,
                              flagship_mb_per_image=flagship['bytes'] / args.batch / 1e6)),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--res', type=int, default=256)
    ap.add_argument('--stacks', type=int, nargs=2, default=[1, 2])
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--rank', type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return 0
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE='2', MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
               OMP_NUM_THREADS='2')
    procs = [subprocess.Popen([sys.executable, __file__, '--rank', str(r), '--res', str(args.res),
                               '--batch', str(args.batch), '--stacks',
                               *map(str, args.stacks)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    return max(p.wait() for p in procs)


if __name__ == '__main__':
    sys.exit(main())
