"""MPII's official PCKh@0.5 evaluation (the metric half of
`hourglass_pose_estimation_tpu/data/mpii.py`).

`evaluate_pckh` reproduces the reference's evaluator (its
datasets/mpii.py:91-176: SC_BIAS=0.6 head-size normalisation, the
per-group table, pelvis and thorax masked out of the mean) and
`save_pred_mat` writes the submission artifact. The MPII reader (image
files, the annotation JSON) is not ported yet: `get_dataset('mpii')`
refuses it until the host-data slice (ROADMAP Queue 1 item 9) brings it.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

# index order of the 16 MPII joints
MPII_JOINT_NAMES = ['rank', 'rkne', 'rhip', 'lhip', 'lkne', 'lank',
                    'pelv', 'thor', 'neck', 'head',
                    'rwri', 'relb', 'rsho', 'lsho', 'lelb', 'lwri']


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
