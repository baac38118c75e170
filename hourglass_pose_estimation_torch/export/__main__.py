"""Export a trained model as a `torch.export` program (.pt2).

    python -m hourglass_pose_estimation_torch.export <config.yaml> \\
        [SECTION.key=value ...] [--device cpu]

The port of `scripts/export.py`: MODEL.* rebuilds the network
(`models.model_from_config`), COMMON.resume names the checkpoint (a port
checkpoint, `runner/checkpoint.py`), and the program goes to
<COMMON.checkpoint_dir>/export/model.pt2 (`export.export_program`) with
the graph options of EVAL.export_keypoints (with EVAL.decode),
EVAL.export_fold_bn, EVAL.export_preprocess (DATASET.name's mean and std),
EVAL.export_batch and EVAL.export_bf16_weights. It is traced on the card
unless --device cpu is given. `serve_http` serves the program it writes.
No TF SavedModel is written: that needs TensorFlow, which the port's
machines lack.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('config', help='YAML config (MODEL, DATASET, EVAL, COMMON)')
    ap.add_argument('overrides', nargs='*', help='SECTION.key=value')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_intermixed_args(argv)

    import torch

    from hourglass_pose_estimation_torch._device import resolve_device
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.data import get_meanstd, resolve_num_classes
    from hourglass_pose_estimation_torch.export import export_program
    from hourglass_pose_estimation_torch.models import model_from_config
    from hourglass_pose_estimation_torch.runner.checkpoint import restore_params

    cfg = load_config(args.config, overrides=args.overrides)
    dev = resolve_device(args.device)
    if not (cfg.common.resume and os.path.exists(cfg.common.resume)):
        raise FileNotFoundError(f"Checkpoint doesn't exist: {cfg.common.resume!r}")
    model = model_from_config(cfg.model, num_classes=resolve_num_classes(cfg),
                              out_res=cfg.dataset.out_res, device=dev)
    state = restore_params(cfg.common.resume, device=dev)

    R = cfg.dataset.inp_res
    decode = cfg.eval.decode if cfg.eval.export_keypoints else None
    # the program takes RAW uint8 frames: /255 -> resize -> normalize run
    # on the device (EVAL.export_preprocess)
    preprocess = get_meanstd(cfg.dataset.name) if cfg.eval.export_preprocess else None
    wdtype = torch.bfloat16 if cfg.eval.export_bf16_weights else None
    path = export_program(model, state, (cfg.eval.export_batch, R, R, 3),
                          os.path.join(cfg.common.checkpoint_dir, 'export', 'model.pt2'),
                          decode=decode, fold_bn=cfg.eval.export_fold_bn,
                          preprocess=preprocess, input_res=R, weights_dtype=wdtype,
                          device=dev)
    print(f'wrote {path}'
          + (f' (fused {decode} decode)' if decode else '')
          + (' (uint8 in, fused preprocess)' if preprocess else '')
          + (f' (batch {cfg.eval.export_batch})' if cfg.eval.export_batch != 1 else '')
          + (' (bf16 weights)' if wdtype is not None else ''))
    print('no SavedModel written: a TF SavedModel needs TensorFlow, which is not '
          'installed; the .pt2 program is the artifact', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
