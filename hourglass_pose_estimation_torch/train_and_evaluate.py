#!/usr/bin/env python
"""Train or evaluate from a YAML config on the card (the port's counterpart
of `scripts/train_and_evaluate.py`).

    python -m hourglass_pose_estimation_torch.train_and_evaluate \\
        <config.yaml> [SECTION.key=value ...] [--device cuda|cpu]

Trains with validation every epoch, snapshots under
`COMMON.checkpoint_dir/<run name>/ckpts/` (the JAX CLI's derived run name,
{dataset}_{arch}_s{stacks}_{mobile}_{subset}) and prints the best val PCK.
`COMMON.resume` resumes from a checkpoint file. `COMMON.evaluate_only=True`
runs the standalone Evaluator on the checkpoint `COMMON.resume` names
instead: the val loss and heatmap PCK and, with `EVAL.official=True`, the
dataset-official table.

Training on N ranks, one process a rank (`parallel/`):

    torchrun --nproc_per_node N -m hourglass_pose_estimation_torch.train_and_evaluate \
        <config.yaml> [SECTION.key=value ...]

NCCL, each rank on cuda:LOCAL_RANK; `--backend gloo` runs several ranks on
one card (with `--device cuda:0`) or on the CPU (`--device cpu`, gloo
there always). `evaluate_only` runs in one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch.distributed as dist

from hourglass_pose_estimation_torch.config import load_config
from hourglass_pose_estimation_torch.parallel.multihost import maybe_initialize_distributed
from hourglass_pose_estimation_torch.runner import checkpoint as ckpt_lib
from hourglass_pose_estimation_torch.runner.evaluator import Evaluator
from hourglass_pose_estimation_torch.runner.trainer import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('config', help='YAML config')
    ap.add_argument('overrides', nargs='*', help='SECTION.key=value')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (the plain path)")
    ap.add_argument('--backend', choices=('nccl', 'gloo'), default=None,
                    help='process-group backend under torchrun (default: nccl on '
                         'cards, gloo on the CPU)')
    args = ap.parse_args(argv)
    cfg = load_config(args.config, overrides=args.overrides)
    cfg = dataclasses.replace(cfg, common=dataclasses.replace(
        cfg.common, checkpoint_dir=os.path.join(cfg.common.checkpoint_dir,
                                                cfg.run_name())))
    if cfg.common.evaluate_only:
        if int(os.environ.get('WORLD_SIZE', '1')) > 1:
            raise ValueError('COMMON.evaluate_only runs in one process, not under '
                             f"torchrun (WORLD_SIZE={os.environ['WORLD_SIZE']})")
        # fail fast on a missing checkpoint, before any dataset is built
        if not (cfg.common.resume and os.path.exists(cfg.common.resume)):
            raise FileNotFoundError(cfg.common.resume or '<COMMON.resume unset>')
        evaluator = Evaluator(cfg, device=args.device)
        # the model and state shell; eval_only skips the train split
        trainer = Trainer(cfg, verbose=False, device=args.device, eval_only=True)
        state = ckpt_lib.restore(cfg.common.resume, trainer.state)['state']
        print(f'Loaded model {cfg.common.resume}', flush=True)
        loss, acc = evaluator.evaluate(state)
        print(f'loss {loss:.5f} | pck {acc:.4f}', flush=True)
        if cfg.eval.official:
            table = evaluator.evaluate_official(state)
            for k, v in table.items():
                print(f'  {k}: {v:.3f}' if isinstance(v, float) else f'  {k}: {v}',
                      flush=True)
        return 0
    owned = not dist.is_initialized()
    rank, _ = maybe_initialize_distributed(device=args.device, backend=args.backend)
    best = Trainer(cfg, device=args.device).train()
    if owned and dist.is_initialized():
        dist.destroy_process_group()
    if rank == 0:
        print(f'best val pck: {best:.4f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
