#!/usr/bin/env python
"""Train from a YAML config on the card (the port's counterpart of
`scripts/train_and_evaluate.py`).

    python -m hourglass_pose_estimation_torch.train_and_evaluate \\
        <config.yaml> [SECTION.key=value ...] [--device cuda|cpu]

Trains with validation every epoch, snapshots under
`COMMON.checkpoint_dir/<run name>/ckpts/` (the JAX CLI's derived run name,
{dataset}_{arch}_s{stacks}_{mobile}_{subset}) and prints the best val PCK.
`COMMON.resume` resumes from a checkpoint file. `COMMON.evaluate_only`
(the standalone evaluator) is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from hourglass_pose_estimation_torch.config import load_config
from hourglass_pose_estimation_torch.runner.trainer import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('config', help='YAML config')
    ap.add_argument('overrides', nargs='*', help='SECTION.key=value')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, overrides=args.overrides)
    if cfg.common.evaluate_only:
        raise NotImplementedError('COMMON.evaluate_only: the standalone evaluator '
                                  'is not ported yet (ROADMAP Queue 1 item 11)')
    cfg = dataclasses.replace(cfg, common=dataclasses.replace(
        cfg.common, checkpoint_dir=os.path.join(cfg.common.checkpoint_dir,
                                                cfg.run_name())))
    trainer = Trainer(cfg, device=args.device)
    best = trainer.train()
    print(f'best val pck: {best:.4f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
