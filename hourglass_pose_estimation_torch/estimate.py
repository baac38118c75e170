#!/usr/bin/env python
"""Single-image pose estimation from a YAML config (the port's counterpart
of `scripts/estimate.py`).

    python -m hourglass_pose_estimation_torch.estimate \\
        <config.yaml> [SECTION.key=value ...] [--device cuda|cpu]

Reads the image COMMON.image_path names (cv2), runs the Estimator on the
checkpoint COMMON.resume names, draws the keypoints (circles, or with
COMMON.skeleton=True the NMS peaks joined by skeleton lines) and writes
COMMON.dest_path. COMMON.device_preprocess=True resizes and normalizes
on the device.
"""

from __future__ import annotations

import argparse
import sys

from hourglass_pose_estimation_torch.config import load_config
from hourglass_pose_estimation_torch.runner.estimator import Estimator


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('config', help='YAML config (MODEL, COMMON)')
    ap.add_argument('overrides', nargs='*', help='SECTION.key=value')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, overrides=args.overrides)

    import cv2
    estimator = Estimator(cfg, device=args.device)
    frame = cv2.imread(cfg.common.image_path)
    if frame is None:
        raise FileNotFoundError(cfg.common.image_path)
    if cfg.common.skeleton:
        from hourglass_pose_estimation_torch.utils.visualize import draw_skeleton
        kps, (hm_h, hm_w) = estimator.run_skeleton(
            frame, device_preprocess=cfg.common.device_preprocess)
        draw_skeleton(frame, kps, scale_x=frame.shape[1] / (hm_w * 4.0),
                      scale_y=frame.shape[0] / (hm_h * 4.0))
    else:
        kps = estimator.run(frame, device_preprocess=cfg.common.device_preprocess)
        for x, y in kps:
            cv2.circle(frame, center=(int(x), int(y)), color=(0, 0, 255),
                       radius=5, thickness=-1)
    if not cv2.imwrite(cfg.common.dest_path, frame):
        raise OSError(f'could not write {cfg.common.dest_path}')
    print(f'wrote {cfg.common.dest_path}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
