"""COCO-family keypoint datasets: MSCOCO (17 keypoints), CrowdPose (14)
and Hands (22, the format of the reference's COCO-WholeBody extraction
tool).

Port of `hourglass_pose_estimation_tpu/data/mscoco.py`: the annotation
file names, the %012d.jpg image paths and the flip pairs of the
reference's datasets/mscoco.py; CrowdPose and Hands share the COCO JSON
format.
"""

from __future__ import annotations

import os

import numpy as np

from hourglass_pose_estimation_torch.data.coco_json import load_coco_keypoints
from hourglass_pose_estimation_torch.data.common import PoseDataset, PoseRecords, register


class _COCOFamily(PoseDataset):
    ann_prefix = 'person_keypoints'
    train_set = 'train2017'
    val_set = 'val2017'
    images_in_set_subdir = True

    def __init__(self, is_train: bool, *, image_path='', annotation_path='',
                 flip=True, label_type='Gaussian', device_pipeline=True,
                 num_samples=0, **kwargs):
        self.images_dir = image_path
        self.anno_dir = annotation_path
        self.image_set = self.train_set if is_train else self.val_set
        super().__init__(is_train, **kwargs)

    def _ann_file(self) -> str:
        return os.path.join(self.anno_dir,
                            f'{self.ann_prefix}_{self.image_set}.json')

    def _image_path(self, file_name: str, image_id: int) -> str:
        name = file_name or ('%012d.jpg' % image_id)
        if self.images_in_set_subdir:
            return os.path.join(self.images_dir, self.image_set, name)
        return os.path.join(self.images_dir, name)

    def _load_records(self) -> PoseRecords:
        d = load_coco_keypoints(self._ann_file(), self.n_joints)
        paths = [self._image_path(fn, iid)
                 for fn, iid in zip(d['file_names'], d['image_ids'])]
        self.image_ids = d['image_ids']
        return PoseRecords(centers=d['centers'], scales=d['scales'],
                           joints=d['joints'], vis=d['vis'],
                           widths=d['widths'], image_paths=paths)


@register
class MSCOCO(_COCOFamily):
    name = 'mscoco'
    n_joints = 17
    flip_pairs = [[1, 2], [3, 4], [5, 6], [7, 8],
                  [9, 10], [11, 12], [13, 14], [15, 16]]
    # OKS per-keypoint sigmas (COCO official), used by data/oks.py
    oks_sigmas = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72,
                           .62, .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0


@register
class CrowdPose(_COCOFamily):
    name = 'crowdpose'
    n_joints = 14
    # CrowdPose order: lsho, rsho, lelb, relb, lwri, rwri, lhip, rhip,
    # lkne, rkne, lank, rank, head, neck
    flip_pairs = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11]]
    train_set = 'trainval'
    val_set = 'test'
    images_in_set_subdir = False

    def _ann_file(self) -> str:
        return os.path.join(self.anno_dir,
                            f'crowdpose_{self.image_set}.json')


@register
class Hands(_COCOFamily):
    """22-keypoint two-hand dataset in the format produced by the
    reference's `tools/extract_full_coco.py` (11 kpts per hand)."""
    name = 'hands'
    n_joints = 22
    # left-hand kpt i <-> right-hand kpt i+11
    flip_pairs = [[i, i + 11] for i in range(11)]


def mscoco(is_train: bool, **kwargs):
    return MSCOCO(is_train, **kwargs)


def crowdpose(is_train: bool, **kwargs):
    return CrowdPose(is_train, **kwargs)


def hands(is_train: bool, **kwargs):
    return Hands(is_train, **kwargs)


mscoco.n_joints = MSCOCO.n_joints
crowdpose.n_joints = CrowdPose.n_joints
hands.n_joints = Hands.n_joints
