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
there always). `TRAIN.pipeline_parallel=P TRAIN.microbatches=M` splits the
hg stacks over P stages of each data rank (N = data_parallel * P ranks);
`TRAIN.model_parallel=T` splits each conv of 128 or more output channels
over T model ranks of each data rank (N = data_parallel * T ranks).
`COMMON.evaluate_only` under torchrun does what the JAX script does: it
initialises the process group, then runs the single-device Evaluator in
every process on the whole validation set; rank 0 alone prints (the lines
of one process) and writes the official metrics' files.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
    owned = not dist.is_initialized()
    rank, _ = maybe_initialize_distributed(device=args.device, backend=args.backend)
    try:
        if cfg.common.evaluate_only:
            evaluate(cfg, args.device, rank)
        else:
            best = Trainer(cfg, device=args.device).train()
            if rank == 0:
                print(f'best val pck: {best:.4f}', flush=True)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def evaluate(cfg, device, rank: int = 0) -> None:
    """The standalone Evaluator on the checkpoint COMMON.resume names, in
    this process alone (every rank of a process group runs it whole);
    rank 0 prints and writes the official metrics' files."""
    # fail fast on a missing checkpoint, before any dataset is built
    if not (cfg.common.resume and os.path.exists(cfg.common.resume)):
        raise FileNotFoundError(cfg.common.resume or '<COMMON.resume unset>')
    say = functools.partial(print, flush=True) if rank == 0 else (lambda *a, **k: None)
    evaluator = Evaluator(cfg, device=device, verbose=rank == 0)
    # the model and state shell; eval_only skips the train split
    trainer = Trainer(cfg, verbose=False, device=device, eval_only=True)
    state = ckpt_lib.restore(cfg.common.resume, trainer.state)['state']
    say(f'Loaded model {cfg.common.resume}')
    loss, acc = evaluator.evaluate(state)
    say(f'loss {loss:.5f} | pck {acc:.4f}')
    if cfg.eval.official:
        table = evaluator.evaluate_official(state, output_dir=None if rank == 0 else '')
        for k, v in table.items():
            say(f'  {k}: {v:.3f}' if isinstance(v, float) else f'  {k}: {v}')


if __name__ == '__main__':
    sys.exit(main())
