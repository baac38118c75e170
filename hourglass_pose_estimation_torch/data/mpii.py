"""MPII (16 joints): the reader and the official PCKh@0.5 evaluation.

Port of `hourglass_pose_estimation_tpu/data/mpii.py`. The reader follows
the reference's datasets/mpii.py:43-89: one JSON list per split
(`train.json`, `valid.json`) of {image, center, scale, joints,
joints_vis}; the center moves down by 15 * scale and the scale grows by
1.25 (where the center is not -1), and coordinates go from MATLAB's
1-based to 0-based. `evaluate_pckh` reproduces the reference's evaluator
(its mpii.py:91-176: SC_BIAS=0.6 head-size normalisation, the per-group
table, pelvis and thorax masked out of the mean) and `save_pred_mat`
writes the submission artifact.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

from hourglass_pose_estimation_torch.data.common import PoseDataset, PoseRecords, register

# index order of the 16 MPII joints
MPII_JOINT_NAMES = ['rank', 'rkne', 'rhip', 'lhip', 'lkne', 'lank',
                    'pelv', 'thor', 'neck', 'head',
                    'rwri', 'relb', 'rsho', 'lsho', 'lelb', 'lwri']


@register
class MPII(PoseDataset):
    name = 'mpii'
    n_joints = 16
    flip_pairs = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]

    def __init__(self, is_train: bool, *, image_path='', annotation_path='',
                 flip=True, label_type='Gaussian', device_pipeline=True,
                 num_samples=0, **kwargs):
        self.images_dir = image_path
        self.anno_dir = annotation_path
        self.image_set = 'train' if is_train else 'valid'
        super().__init__(is_train, **kwargs)

    def _load_records(self) -> PoseRecords:
        fname = os.path.join(self.anno_dir, self.image_set + '.json')
        with open(fname) as fp:
            anno = json.load(fp)

        N = len(anno)
        centers = np.zeros((N, 2), np.float32)
        scales = np.zeros((N, 2), np.float32)
        joints = np.zeros((N, self.n_joints, 2), np.float32)
        vis = np.zeros((N, self.n_joints), np.float32)
        widths = np.zeros((N,), np.float32)
        paths = []
        for i, a in enumerate(anno):
            c = np.array(a['center'], np.float64)
            s = np.array([a['scale'], a['scale']], np.float64)
            if c[0] != -1:
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            c = c - 1  # matlab 1-based -> 0-based
            j = np.array(a['joints'], np.float64)
            j[:, :2] -= 1
            v = np.array(a['joints_vis'], np.float64)
            centers[i] = c
            scales[i] = s
            joints[i] = j[:, :2]
            vis[i] = v
            # the annotations store no width: the pipelines read it from the
            # image (the flip needs it)
            widths[i] = -1.0
            paths.append(os.path.join(self.images_dir, a['image']))
        return PoseRecords(centers=centers, scales=scales, joints=joints,
                           vis=vis, widths=widths, image_paths=paths)


def save_pred_mat(preds: np.ndarray, output_dir: str) -> str:
    """Write the official submission artifact `pred.mat` (1-based).

    Parity: the reference's datasets/mpii.py:95-97, the evaluator's side
    effect, kept as its own function so the Evaluator can emit it for the
    test split too.
    """
    from scipy.io import savemat
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, 'pred.mat')
    savemat(path, mdict={'preds': np.asarray(preds)[:, :, :2] + 1.0})
    return path


def evaluate_pckh(preds: np.ndarray, gt_file: str,
                  output_dir: str = '',
                  image_set: str = 'valid') -> Tuple[Dict[str, float], float]:
    """Official MPII PCKh@0.5 against the gt .mat file.

    Args:
      preds: [N, 16, 2] predicted keypoints in original-image pixels,
        0-based (converted to 1-based internally, as the reference does).
      gt_file: path to gt_valid.mat (MATLAB format).
      output_dir: when set, save `pred.mat` there (reference side
        effect, mpii.py:95-97).
      image_set: a 'test' split has no public ground truth — return the
        reference's `({'Null': 0.0}, 0.0)` short-circuit after saving
        the submission artifact (mpii.py:99-100).

    Returns (table, mean) like the reference's dead-code evaluator
    (mpii.py:91-176): Head/Shoulder/Elbow/Wrist/Hip/Knee/Ankle/Mean and
    Mean@0.1, with pelvis/thorax (6, 7) masked out of the mean.
    """
    from scipy.io import loadmat

    if output_dir:
        save_pred_mat(preds, output_dir)
    if 'test' in image_set or not gt_file:
        # test split (no public gt) or no gt .mat available: the
        # submission artifact is the whole output (mpii.py:99-100)
        return OrderedDict([('Null', 0.0)]), 0.0

    preds = np.asarray(preds)[:, :, :2] + 1.0
    gt = loadmat(gt_file)
    dataset_joints = gt['dataset_joints']
    jnt_missing = gt['jnt_missing']
    pos_gt_src = gt['pos_gt_src']
    headboxes_src = gt['headboxes_src']

    pos_pred_src = np.transpose(preds, [1, 2, 0])

    def jidx(name):
        return np.where(dataset_joints == name)[1][0]

    SC_BIAS = 0.6
    jnt_visible = 1 - jnt_missing
    uv_err = np.linalg.norm(pos_pred_src - pos_gt_src, axis=1)
    headsizes = np.linalg.norm(
        headboxes_src[1, :, :] - headboxes_src[0, :, :], axis=0) * SC_BIAS
    scaled_err = (uv_err / headsizes[None, :]) * jnt_visible
    jnt_count = np.sum(jnt_visible, axis=1)

    def pck_at(thr):
        less = (scaled_err <= thr) * jnt_visible
        return 100.0 * np.sum(less, axis=1) / jnt_count

    PCKh = pck_at(0.5)
    pck01 = pck_at(0.11)  # reference indexes rng[11] == 0.11

    PCKh = np.ma.array(PCKh, mask=False)
    PCKh.mask[6:8] = True
    jc = np.ma.array(jnt_count, mask=False)
    jc.mask[6:8] = True
    ratio = jc / np.sum(jc).astype(np.float64)

    table = OrderedDict([
        ('Head', PCKh[jidx('head')]),
        ('Shoulder', 0.5 * (PCKh[jidx('lsho')] + PCKh[jidx('rsho')])),
        ('Elbow', 0.5 * (PCKh[jidx('lelb')] + PCKh[jidx('relb')])),
        ('Wrist', 0.5 * (PCKh[jidx('lwri')] + PCKh[jidx('rwri')])),
        ('Hip', 0.5 * (PCKh[jidx('lhip')] + PCKh[jidx('rhip')])),
        ('Knee', 0.5 * (PCKh[jidx('lkne')] + PCKh[jidx('rkne')])),
        ('Ankle', 0.5 * (PCKh[jidx('lank')] + PCKh[jidx('rank')])),
        ('Mean', float(np.sum(PCKh * ratio))),
        ('Mean@0.1', float(np.sum(pck01 * ratio))),
    ])
    return table, table['Mean']
