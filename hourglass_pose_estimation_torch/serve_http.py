#!/usr/bin/env python
"""HTTP keypoint server on the card: an exported program, or config +
weights -> served model.

Counterpart of `tools/serve_http.py`. Given one exported program (a .pt2
that `python -m hourglass_pose_estimation_torch.export` wrote), it serves
that, at the program's own static batch and frame shape
(`serving.load_serving_artifact`), as the JAX tool serves a StableHLO
artifact. Given a config YAML (MODEL.*, DATASET.inp_res and name,
EVAL.export_*) and a weights file (`torch.save` of the port model's
`state_dict`), it builds the inference function in process with
`export.make_inference_fn`. Either is served the same way: a dynamic
micro-batcher pads partial batches to the static batch, and
SIGTERM/SIGINT drain the in-flight batches before exit.

    python -m hourglass_pose_estimation_torch.serve_http \\
        checkpoints/export/model.pt2 --port 8000
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
    from hourglass_pose_estimation_torch.models import model_from_config

    dev = resolve_device(device)
    model = model_from_config(cfg.model, num_classes=resolve_num_classes(cfg),
                              out_res=cfg.dataset.out_res, device=dev)
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
    ap.add_argument('inputs', nargs='+', metavar='ARTIFACT | CONFIG WEIGHTS [OVERRIDES]',
                    help='an exported program (.pt2), or a YAML config (MODEL, '
                         'DATASET, EVAL), a torch.save of the model state_dict '
                         'and SECTION.key=value overrides')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8000)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--max-wait-ms', type=float, default=5.0,
                    help='linger after the first queued frame before '
                         'dispatching a partial batch')
    ap.add_argument('--max-queue', type=int, default=0,
                    help='queued-frame cap before submits get HTTP 503 '
                         '(0 = 8 batches)')
    args = ap.parse_intermixed_args(argv)

    import numpy as np

    from hourglass_pose_estimation_torch.serving import (
        MicroBatcher, load_serving_artifact, make_server)

    if len(args.inputs) == 1 and args.inputs[0].endswith('.pt2'):
        what = args.inputs[0]
        fn, batch, frame_shape, dtype = load_serving_artifact(what, args.device)
    elif len(args.inputs) >= 2:
        from hourglass_pose_estimation_torch.config import load_config
        cfg = load_config(args.inputs[0], overrides=args.inputs[2:])
        what = f'{cfg.model.arch} s{cfg.model.num_stacks}'
        fn, batch, frame_shape, dtype = build_inference(cfg, args.inputs[1], args.device)
    else:
        ap.error('give an exported program (.pt2), or a config and weights')
    fn(np.zeros((batch,) + frame_shape, dtype))    # build kernels, warm up
    batcher = MicroBatcher(fn, batch, frame_shape, dtype=dtype,
                           max_wait_ms=args.max_wait_ms,
                           max_queue=args.max_queue)
    srv = make_server(batcher, args.host, args.port)
    print(f'serving {what} on {args.device} (batch {batch}, frame {frame_shape} '
          f'{dtype}) on http://{srv.server_address[0]}:{srv.server_address[1]}',
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
