#!/usr/bin/env python
"""HTTP keypoint server on the card: config + weights -> served model.

Counterpart of `tools/serve_http.py`, which serves an exported StableHLO
artifact. Here the inference function is built in process by
`export.make_inference_fn` from a config YAML (MODEL.*, DATASET.inp_res
and name, EVAL.export_*) and a weights file (`torch.save` of the port
model's `state_dict`), then served the same way: a dynamic micro-batcher
pads partial batches to EVAL.export_batch, and SIGTERM/SIGINT drain the
in-flight batches before exit.

    python -m hourglass_pose_estimation_torch.serve_http \\
        configs/train_mpii_8stack.yaml weights.pt --port 8000 \\
        EVAL.export_keypoints=true EVAL.export_preprocess=true \\
        EVAL.export_batch=64

    curl -X POST --data-binary @frame.npy \\
        -H 'Content-Type: application/x-npy' http://127.0.0.1:8000/keypoints
    curl http://127.0.0.1:8000/stats
"""

from __future__ import annotations

import argparse
import sys


def build_inference(cfg, weights: str, device='cuda'):
    """(inference fn, batch, frame shape, input dtype) for a config."""
    import numpy as np
    import torch

    from hourglass_pose_estimation_torch._device import resolve_device
    from hourglass_pose_estimation_torch.data import (
        get_meanstd, resolve_num_classes)
    from hourglass_pose_estimation_torch.export import make_inference_fn
    from hourglass_pose_estimation_torch.models import get_model

    dev = resolve_device(device)
    model = get_model(cfg.model.arch, device=dev,
                      num_stacks=cfg.model.num_stacks,
                      num_blocks=cfg.model.num_blocks,
                      num_classes=resolve_num_classes(cfg),
                      mobile=cfg.model.mobile, skip_mode=cfg.model.skip_mode,
                      up_channel_num=cfg.model.up_channel_num,
                      fuse_block=cfg.model.fuse_block,
                      fuse_upsample=cfg.model.fuse_block)
    state = torch.load(weights, map_location=dev, weights_only=True)
    preprocess = (get_meanstd(cfg.dataset.name)
                  if cfg.eval.export_preprocess else None)
    fn = make_inference_fn(
        model, state, decode=cfg.eval.decode if cfg.eval.export_keypoints else None,
        fold_bn=cfg.eval.export_fold_bn,
        weights_dtype=torch.bfloat16 if cfg.eval.export_bf16_weights else None,
        preprocess=preprocess, input_res=cfg.dataset.inp_res, device=dev)
    R = cfg.dataset.inp_res
    dtype = np.uint8 if preprocess is not None else np.float32
    return fn, cfg.eval.export_batch, (R, R, 3), np.dtype(dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('config', help='YAML config (MODEL, DATASET, EVAL)')
    ap.add_argument('weights', help='torch.save of the model state_dict')
    ap.add_argument('overrides', nargs='*', help='SECTION.key=value')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8000)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--max-wait-ms', type=float, default=5.0,
                    help='linger after the first queued frame before '
                         'dispatching a partial batch')
    ap.add_argument('--max-queue', type=int, default=0,
                    help='queued-frame cap before submits get HTTP 503 '
                         '(0 = 8 batches)')
    args = ap.parse_args(argv)

    import numpy as np

    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.serving import MicroBatcher, make_server

    cfg = load_config(args.config, overrides=args.overrides)
    fn, batch, frame_shape, dtype = build_inference(cfg, args.weights,
                                                    args.device)
    fn(np.zeros((batch,) + frame_shape, dtype))    # build kernels, warm up
    batcher = MicroBatcher(fn, batch, frame_shape, dtype=dtype,
                           max_wait_ms=args.max_wait_ms,
                           max_queue=args.max_queue)
    srv = make_server(batcher, args.host, args.port)
    print(f'serving {cfg.model.arch} s{cfg.model.num_stacks} on '
          f'{args.device} (batch {batch}, frame {frame_shape} {dtype}) on '
          f'http://{srv.server_address[0]}:{srv.server_address[1]}',
          flush=True)

    # SIGTERM/SIGINT: stop taking requests, drain in-flight batches and
    # release the device cleanly (background shells ignore SIGINT, so
    # SIGTERM is the operational stop signal)
    import signal
    import threading
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        while not stop.wait(0.5):
            pass
    finally:
        srv.shutdown()
        batcher.close()
        print('drained; bye', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
