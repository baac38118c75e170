"""Keypoint and skeleton drawing on host frames (cv2, imported where it
draws). The port's copy of `hourglass_pose_estimation_tpu/utils/
visualize.py`: the reference's visualizer (`render_kps` circles, and
skeleton lines over BODY_PARTS_KPT_IDS with the x4 heatmap stride folded
into the scale). The peaks it draws come from `ops.decode.
decode_nms_peaks`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# COCO-17 limb pairs, exactly the reference's table (utils.py:4-21),
# including its duplicated [0,1]/[0,2] tail entries.
BODY_PARTS_KPT_IDS = [
    [15, 13], [13, 11], [16, 14], [14, 12], [5, 11], [6, 12], [5, 7],
    [6, 8], [7, 9], [8, 10], [0, 1], [0, 2], [1, 3], [2, 4], [0, 5],
    [0, 6], [0, 1], [0, 2],
]

# MPII-16 limb pairs (no equivalent table in the reference, which only
# draws COCO skeletons; joint order per MPII: 0-5 legs, 6 pelvis,
# 7 thorax, 8 neck, 9 head, 10-15 arms).
MPII_PARTS_KPT_IDS = [
    [0, 1], [1, 2], [2, 6], [3, 6], [3, 4], [4, 5], [6, 7], [7, 8],
    [8, 9], [10, 11], [11, 12], [12, 7], [13, 7], [13, 14], [14, 15],
]

_KP_COLOR = (0, 0, 255)       # BGR red (reference parity)
_LINE_COLOR = (0, 255, 255)   # BGR yellow (reference parity)


def render_kps(image: np.ndarray, kps: np.ndarray, scale_x: float = 1.0,
               scale_y: float = 1.0, stride: int = 4,
               radius: int = 2) -> np.ndarray:
    """Draw one circle per (x, y[, conf]) keypoint row.

    Coordinates are in heatmap space, scaled by stride * scale to the
    frame (the reference's visualizer utils.py:71-75).
    """
    import cv2
    for kp in np.asarray(kps):
        x, y = kp[0], kp[1]
        cv2.circle(image, center=(int(x * stride * scale_x),
                                  int(y * stride * scale_y)),
                   color=_KP_COLOR, radius=radius)
    return image


def draw_skeleton(image: np.ndarray, kps: np.ndarray, scale_x: float = 1.0,
                  scale_y: float = 1.0, thr: float = 0.01, stride: int = 4,
                  parts: Sequence[Sequence[int]] = None) -> np.ndarray:
    """Skeleton-line renderer.

    The reference's `visualize` (utils.py:78-96): for each limb pair draw the
    endpoint circles when their confidence clears `thr` and the
    connecting line when both do. `kps` is [J, 3] (x, y, conf) in
    heatmap coordinates (e.g. from `decode_nms_peaks`); `parts` defaults
    by joint count (17 -> COCO, 16 -> MPII; other counts keep the COCO
    pairs that fit, so e.g. 14-joint crowdpose renders its shared limbs
    instead of indexing out of bounds — pass an explicit table for an
    exact skeleton).
    """
    import cv2
    kps = np.asarray(kps)
    if parts is None:
        J = kps.shape[0]
        if J == 16:
            parts = MPII_PARTS_KPT_IDS
        else:
            parts = [(a, b) for a, b in BODY_PARTS_KPT_IDS
                     if a < J and b < J]
    for a, b in parts:
        ca, cb = kps[a, 2], kps[b, 2]
        xa = (int(kps[a, 0] * stride * scale_x), int(kps[a, 1] * stride * scale_y))
        xb = (int(kps[b, 0] * stride * scale_x), int(kps[b, 1] * stride * scale_y))
        if ca > thr:
            cv2.circle(image, center=xa, color=_KP_COLOR, radius=2)
        if cb > thr:
            cv2.circle(image, center=xb, color=_KP_COLOR, radius=2)
        if ca > thr and cb > thr:
            cv2.line(image, xa, xb, _LINE_COLOR, 2)
    return image
