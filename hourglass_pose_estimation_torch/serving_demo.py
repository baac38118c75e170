#!/usr/bin/env python
"""Deployment demos over an exported program: sync, async, sustained.

Counterpart of `tools/serving_demo.py`, over a .pt2 program that
`python -m hourglass_pose_estimation_torch.export` wrote (loaded with
`export.load_program`, on the card unless --device cpu is given):

  * `sync`: timed single-image calls (each ends on a host copy of the
    result), the keypoints drawn on the frame (--out), and with
    --profile <dir> one call's trace (`utils.summary.profile_step`);
  * `async`: a directory of frames, pipelined: the host reads and prepares
    frame i+1 while the card runs frame i, then draws frame i;
  * `sustained`: chained calls, each input depending on the last result,
    with one host copy at the end; N/2 and N calls, whose difference
    removes the fixed cost of that copy.

A program exported with EVAL.export_preprocess takes raw uint8 frames
(--raw: the frame is resized to --res on the host, /255 and normalize run
in the program); else the host normalizes with --dataset's mean and std.
A keypoint program's (keypoints, maxvals) are drawn as circles; a heatmap
program's are decoded on the host's side with the port's
`decode_simple_argmax`, or `decode_nms_peaks` and `draw_skeleton` with
--skeleton.

    python -m hourglass_pose_estimation_torch.serving_demo sync model.pt2 frame.jpg --raw
    python -m hourglass_pose_estimation_torch.serving_demo async model.pt2 frames/ out/ --raw
    python -m hourglass_pose_estimation_torch.serving_demo sustained model.pt2 frame.jpg --raw
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np


def prepare(image_path: str, res: int, mean, std, raw: bool = False):
    """-> (the frame as read, the program's input [1, res, res, 3]): uint8
    when `raw`, else /255, normalized and resized on the host."""
    import cv2
    frame = cv2.imread(image_path)
    if frame is None:
        raise FileNotFoundError(image_path)
    if raw:
        return frame, cv2.resize(frame, (res, res))[None]
    x = frame.astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return frame, cv2.resize(x, (res, res))[None]


def to_host(out):
    """The program's result (a tensor or a tuple of them) on the host."""
    if isinstance(out, (tuple, list)):
        return tuple(t.cpu() for t in out)
    return out.cpu()


def draw(frame, out, skeleton: bool = False, res: int = 256):
    """Draw a host result of the program on `frame` (in place)."""
    import cv2
    import torch

    from hourglass_pose_estimation_torch.ops.decode import (
        decode_nms_peaks, decode_simple_argmax)
    from hourglass_pose_estimation_torch.utils.visualize import draw_skeleton
    h, w = frame.shape[:2]
    if isinstance(out, tuple):
        # a keypoint program: (keypoints in network-input pixels, maxvals);
        # the joints whose peak clears the 0.02 gate of the heatmap branch
        kps = out[0][0].numpy() * np.array([w / res, h / res])
        for (x, y), c in zip(kps, out[1][0].reshape(-1).numpy()):
            if c > 0.02:
                cv2.circle(frame, (int(x), int(y)), 5, (0, 0, 255), -1)
        return frame
    if skeleton:
        kps = decode_nms_peaks(out)[0].numpy()
        hm_h, hm_w = out.shape[1:3]
        return draw_skeleton(frame, kps, scale_x=w / (hm_w * 4.0), scale_y=h / (hm_h * 4.0))
    kps, _ = decode_simple_argmax(out.to(torch.float32), (res, res), (w, h))
    for x, y in kps[0].numpy():
        if x or y:
            cv2.circle(frame, (int(x), int(y)), 5, (0, 0, 255), -1)
    return frame


def run_sync(args, fn) -> int:
    from hourglass_pose_estimation_torch.data import get_meanstd
    from hourglass_pose_estimation_torch.utils.summary import profile_step
    mean, std = get_meanstd(args.dataset)
    frame, x = prepare(args.image, args.res, mean, std, raw=args.raw)
    out = to_host(fn(x))                        # kernel builds, warm-up
    if args.profile:
        print(f'profile written to {profile_step(fn, x, trace_dir=args.profile)}')
    ts = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        out = to_host(fn(x))
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts) * 1e3
    print(f'avg {ts.mean():.3f} ms | median {np.median(ts):.3f} ms | '
          f'min {ts.min():.3f} ms over {args.iters} iters')
    img = draw(frame, out, skeleton=args.skeleton, res=args.res)
    if args.out:
        import cv2
        cv2.imwrite(args.out, img)
        print(f'wrote {args.out}')
    return 0


def run_async(args, fn) -> int:
    """The host reads and prepares frame i+1 while the card runs frame i
    (the calls return once their kernels are queued); frame i's result
    is then copied to the host and drawn."""
    import cv2
    import torch

    from hourglass_pose_estimation_torch.data import get_meanstd
    mean, std = get_meanstd(args.dataset)
    paths = sorted(glob.glob(os.path.join(args.frame_dir, '*')))
    if not paths:
        raise FileNotFoundError(f'no frames in {args.frame_dir}')
    os.makedirs(args.out_dir, exist_ok=True)
    frame, x = prepare(paths[0], args.res, mean, std, raw=args.raw)
    draw(frame, to_host(fn(x)), skeleton=args.skeleton, res=args.res)    # warm-up

    def finish(pending):
        path, frame, out = pending
        img = draw(frame, to_host(out), skeleton=args.skeleton, res=args.res)
        cv2.imwrite(os.path.join(args.out_dir, os.path.basename(path)), img)

    t0 = time.perf_counter()
    pending, n = None, 0
    for path in paths:
        try:
            frame, x = prepare(path, args.res, mean, std, raw=args.raw)
        except FileNotFoundError:
            continue                            # not an image
        if pending is not None:
            finish(pending)
            n += 1
        pending = (path, frame, fn(x))
    finish(pending)
    n += 1
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f'{n} frames in {dt:.2f}s = {n / dt:.1f} FPS (pipelined)')
    return 0


def run_sustained(args, fn) -> int:
    """Chained calls: each input adds 0 times an element of the last
    result, so no call can start before the one before it ended, and one
    host copy at the end bounds them all. N/2 and N calls: the difference
    over N/2 is the per-call time without that copy."""
    import torch

    from hourglass_pose_estimation_torch.data import get_meanstd
    mean, std = get_meanstd(args.dataset)
    _, x = prepare(args.image, args.res, mean, std, raw=args.raw)
    first = lambda o: o[0] if isinstance(o, tuple) else o
    out = fn(x)
    to_host(out)                                # kernel builds, warm-up
    x = torch.as_tensor(x).to(first(out).device)

    def run(n):
        t0 = time.perf_counter()
        xi, o = x, out
        for _ in range(n):
            o = fn(xi)
            xi = x + (first(o).reshape(-1)[0] * 0).to(x.dtype)
        to_host(o)
        return time.perf_counter() - t0

    n_half = max(args.iters // 2, 1)
    t_half = run(n_half)
    t_full = run(args.iters)
    diff_ms = (t_full - t_half) / max(args.iters - n_half, 1) * 1e3
    print(f'{args.iters} frames in {t_full:.2f}s = {args.iters / t_full:.1f} FPS raw | '
          f'differential {diff_ms:.2f} ms/frame')
    return 0


MODES = {'sync': run_sync, 'async': run_async, 'sustained': run_sustained}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest='mode', required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--res', type=int, default=256)
    common.add_argument('--dataset', default='mscoco')
    common.add_argument('--raw', action='store_true',
                        help='a program exported with EVAL.export_preprocess '
                             '(uint8 frames in)')
    common.add_argument('--device', default='cuda')
    ps = sub.add_parser('sync', parents=[common])
    ps.add_argument('model')
    ps.add_argument('image')
    ps.add_argument('--iters', type=int, default=50)
    ps.add_argument('--profile', default='', help='write a trace of one call here')
    ps.add_argument('--out', default='', help='write the drawn frame here')
    ps.add_argument('--skeleton', action='store_true',
                    help='NMS decode + skeleton lines (heatmap programs)')
    pa = sub.add_parser('async', parents=[common])
    pa.add_argument('model')
    pa.add_argument('frame_dir')
    pa.add_argument('out_dir')
    pa.add_argument('--skeleton', action='store_true')
    pu = sub.add_parser('sustained', parents=[common])
    pu.add_argument('model')
    pu.add_argument('image')
    pu.add_argument('--iters', type=int, default=100)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from hourglass_pose_estimation_torch.export import load_program
    args = parse_args(argv)
    return MODES[args.mode](args, load_program(args.model, args.device))


if __name__ == '__main__':
    sys.exit(main())
