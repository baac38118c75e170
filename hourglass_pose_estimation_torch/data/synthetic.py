"""Synthetic pose dataset: procedurally drawn figures with known joints.

Port of `hourglass_pose_estimation_tpu/data/synthetic.py` (numpy, the
same images and joints for the same index): bright Gaussian blobs at the
joints, paired joints drawn alike (the lower index always image-left, so
a flip with its pair swap gives consistent supervision), line segments
along the skeleton, over uniform noise.
"""

from __future__ import annotations

import numpy as np

from hourglass_pose_estimation_torch.data.common import (
    PoseDataset, PoseRecords, register)

_SKELETON = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (6, 7), (7, 8),
             (8, 9), (10, 11), (11, 12), (12, 13), (13, 14), (14, 15)]


def _make_sample(idx: int, res: int, n_joints: int):
    rng = np.random.RandomState(10_000 + idx)
    img = (rng.uniform(0, 60, size=(res, res, 3))).astype(np.float32)
    joints = rng.uniform(0.2 * res, 0.8 * res, size=(n_joints, 2)).astype(np.float32)
    vis = (rng.uniform(size=(n_joints,)) > 0.1).astype(np.float32)

    color_group = np.arange(n_joints)
    for a, b in Synthetic.flip_pairs:
        if a < n_joints and b < n_joints:
            color_group[b] = color_group[a]
            if joints[a, 0] > joints[b, 0]:
                joints[[a, b]] = joints[[b, a]]
                vis[[a, b]] = vis[[b, a]]

    ys, xs = np.mgrid[0:res, 0:res].astype(np.float32)
    for j in range(n_joints):
        if vis[j] == 0:
            continue
        cx, cy = joints[j]
        g = color_group[j]
        blob = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * 9.0))
        color = np.array([40 + 215 * ((g * 37) % 7) / 6.0,
                          40 + 215 * ((g * 53) % 11) / 10.0,
                          40 + 215 * ((g * 29) % 13) / 12.0], np.float32)
        img += blob[..., None] * color
    for a, b in _SKELETON:
        if a < n_joints and b < n_joints and vis[a] > 0 and vis[b] > 0:
            for t in np.linspace(0, 1, 24):
                p = joints[a] * (1 - t) + joints[b] * t
                x0, y0 = int(p[0]), int(p[1])
                if 0 <= x0 < res and 0 <= y0 < res:
                    img[y0, x0] += 60.0
    return np.clip(img, 0, 255).astype(np.uint8), joints, vis


@register
class Synthetic(PoseDataset):
    name = 'synthetic'
    n_joints = 16
    flip_pairs = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
    # the stored scale is res/200 with no 1.25 box expansion (unlike the
    # mpii and coco readers): the OKS area must not divide one out
    scale_stored_expand = 1.0

    def __init__(self, is_train: bool, *, num_samples=512, **kwargs):
        self._num_samples = int(num_samples)
        self._seed_offset = 0 if is_train else 1_000_000
        super().__init__(is_train, **kwargs)

    def _load_records(self) -> PoseRecords:
        N = self._num_samples
        res = max(self.inp_res, 64)
        images = np.zeros((N, res, res, 3), np.uint8)
        joints = np.zeros((N, self.n_joints, 2), np.float32)
        vis = np.zeros((N, self.n_joints), np.float32)
        for i in range(N):
            images[i], joints[i], vis[i] = _make_sample(
                i + self._seed_offset, res, self.n_joints)
        return PoseRecords(
            centers=np.full((N, 2), res / 2.0, np.float32),
            # the 200 px-convention box covers the image
            scales=np.full((N, 2), res / 200.0, np.float32),
            joints=joints, vis=vis,
            widths=np.full((N,), float(res), np.float32), images=images)
