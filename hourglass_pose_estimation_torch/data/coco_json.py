"""Minimal COCO keypoints JSON reader (no pycocotools).

Port of `hourglass_pose_estimation_tpu/data/coco_json.py`. The subset a
top-down keypoint trainer needs (the images index and each image's person
annotations) is a plain dict walk, with the reference's loading rules
(its common.py:265-335):

  * skip crowd annotations,
  * clip the bbox to the image and require area > 0,
  * skip annotations whose keypoints are all zero,
  * clamp visibility flags above 1 to 1,
  * bbox -> (center, scale): aspect ratio 1.0, / 200, x 1.25.
"""

from __future__ import annotations

import json

import numpy as np

from hourglass_pose_estimation_torch.data.common import PIXEL_STD


def load_coco_keypoints(ann_file: str, n_joints: int,
                        aspect_ratio: float = 1.0,
                        scale_expand: float = 1.25):
    """Parse a COCO-format keypoints annotation file.

    Returns dict of packed arrays:
      centers [N,2], scales [N,2], joints [N,J,2], vis [N,J],
      widths [N], image_ids [N], file_names list[str].
    """
    with open(ann_file) as fp:
        coco = json.load(fp)

    images = {im['id']: im for im in coco.get('images', [])}
    centers, scales, joints_l, vis_l, widths, image_ids, file_names = \
        [], [], [], [], [], [], []

    for ann in coco.get('annotations', []):
        if ann.get('iscrowd', 0):
            continue
        kps = ann.get('keypoints')
        if not kps or max(kps) == 0:
            continue
        im = images.get(ann['image_id'])
        if im is None:
            continue
        width, height = im['width'], im['height']

        x, y, w, h = ann['bbox']
        x1, y1 = max(0, x), max(0, y)
        x2 = min(width - 1, x1 + max(0, w - 1))
        y2 = min(height - 1, y1 + max(0, h - 1))
        if ann.get('area', w * h) <= 0 or x2 < x1 or y2 < y1:
            continue
        cw, ch = x2 - x1, y2 - y1

        j = np.zeros((n_joints, 2), np.float32)
        v = np.zeros((n_joints,), np.float32)
        for p in range(min(n_joints, len(kps) // 3)):
            j[p] = kps[p * 3], kps[p * 3 + 1]
            v[p] = min(1.0, float(kps[p * 3 + 2]))

        c, s = xywh_to_center_scale(x1, y1, cw, ch, aspect_ratio, scale_expand)
        centers.append(c)
        scales.append(s)
        joints_l.append(j)
        vis_l.append(v)
        widths.append(float(width))
        image_ids.append(ann['image_id'])
        file_names.append(im.get('file_name', ''))

    N = len(centers)
    return {
        'centers': np.asarray(centers, np.float32).reshape(N, 2),
        'scales': np.asarray(scales, np.float32).reshape(N, 2),
        'joints': np.asarray(joints_l, np.float32).reshape(N, n_joints, 2),
        'vis': np.asarray(vis_l, np.float32).reshape(N, n_joints),
        'widths': np.asarray(widths, np.float32).reshape(N),
        'image_ids': np.asarray(image_ids, np.int64).reshape(N),
        'file_names': file_names,
    }


def xywh_to_center_scale(x, y, w, h, aspect_ratio=1.0, scale_expand=1.25):
    """The reference's xywh2cs (its common.py:341-356)."""
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / PIXEL_STD, h / PIXEL_STD], np.float32)
    if center[0] != -1:
        scale = scale * scale_expand
    return center, scale
