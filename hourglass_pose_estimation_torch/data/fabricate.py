"""Seeded MPII- and COCO-format trees on disk, for smoke runs and tests
where the real datasets are absent.

Each tree is in the exact on-disk format its reader takes (`data/mpii.py`,
`data/mscoco.py`): JPEG images (cv2, quality 95) of smooth seeded content
with a coloured disc at each visible joint, and the annotation files. The
MPII tree also has `gt_valid.mat` in the official layout
(`dataset_joints`, `jnt_missing`, `pos_gt_src`, `headboxes_src`) for its
valid persons. The COCO-family trees add one crowd, one zero-area and one
all-zero-keypoint annotation per split, which the reader must skip.
Everything comes from the `np.random.RandomState` passed in. cv2 and scipy
are imported where a file is written.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from hourglass_pose_estimation_torch.data.mpii import MPII_JOINT_NAMES

# MPII joints in a box of side 1 around the person's center (x right, y
# down; the person faces the camera, so its right side is image-left)
_MPII_POSE = np.array([
    [-0.10, 0.45], [-0.10, 0.25], [-0.08, 0.05], [0.08, 0.05], [0.10, 0.25], [0.10, 0.45],
    [0.00, 0.05], [0.00, -0.20], [0.00, -0.27], [0.00, -0.42],
    [-0.25, 0.00], [-0.20, -0.10], [-0.12, -0.22], [0.12, -0.22], [0.20, -0.10], [0.25, 0.00]])


def smooth_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """[h, w, 3] uint8: seeded noise on a 32 px grid, upsampled bicubically."""
    import cv2
    low = rng.randint(0, 256, size=(h // 32 + 2, w // 32 + 2, 3)).astype(np.uint8)
    return cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)


def _write_image(path: str, img: np.ndarray, joints, vis) -> None:
    """The image with a disc at each visible joint, written as JPEG."""
    import cv2
    img = img.copy()
    r = max(2, min(img.shape[:2]) // 80)
    for j, ((x, y), v) in enumerate(zip(joints, vis)):
        if v > 0:
            color = tuple(int(c) for c in ((j * 67) % 256, (j * 131 + 80) % 256, (j * 29 + 160) % 256))
            cv2.circle(img, (int(round(x)), int(round(y))), r, color, -1)
    if not cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 95]):
        raise OSError(f'cv2 could not write {path}')


def _slots(n: int, per_image: int, w: int):
    """(image number, slot center x, slot width) of each of n persons."""
    for i in range(n):
        k = i % per_image
        yield i // per_image, (k + 0.5) * w / per_image, w / per_image


def mpii_tree(root: str, rng: np.random.RandomState, *, n_train: int, n_valid: int,
              image_size: Tuple[int, int] = (1280, 720), per_image: int = 2,
              scales: Tuple[float, float] = (1.5, 3.5), n_small: int = 0,
              small_scale: float = 0.9, p_visible: float = 0.85) -> Tuple[str, str, str]:
    """An MPII-format tree under `root`: `images/*.jpg` (`image_size` (w, h),
    `per_image` persons side by side), `annot/{train,valid}.json` and
    `annot/gt_valid.mat`. Persons have annotated scales (height / 200 px)
    uniform in `scales`, except the first `n_small` valid persons, at
    `small_scale`; each joint is visible with probability `p_visible`.
    Returns (image_path, annotation_path, gt_mat)."""
    from scipy.io import savemat
    w, h = image_size
    img_dir, ann_dir = os.path.join(root, 'images'), os.path.join(root, 'annot')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    gt_joints, gt_vis, heads = [], [], []
    for split, n in (('train', n_train), ('valid', n_valid)):
        anno, people = [], {}
        for i, (img_i, cx, slot_w) in enumerate(_slots(n, per_image, w)):
            s = small_scale if split == 'valid' and i < n_small else rng.uniform(*scales)
            s = min(s, min(h, 2 * slot_w) / 200.0)          # the person fits its slot
            side = s * 200.0
            c = np.array([cx + rng.uniform(-0.05, 0.05) * slot_w,
                          h / 2.0 + rng.uniform(-0.5, 0.5) * (h - side) * 0.9])
            joints = c + _MPII_POSE * side + rng.normal(0.0, 0.015 * side, size=(16, 2))
            joints = np.clip(joints, 0.0, [w - 1.0, h - 1.0])
            vis = (rng.uniform(size=16) < p_visible).astype(np.int64)
            name = f'{split}_{img_i:04d}.jpg'
            people.setdefault(name, []).append((joints, vis))
            # 1-based, as the MPII annotations are
            anno.append({'image': name, 'center': (c + 1.0).tolist(), 'scale': float(s),
                         'joints': (joints + 1.0).tolist(), 'joints_vis': vis.tolist()})
            if split == 'valid':
                gt_joints.append(joints + 1.0)
                gt_vis.append(vis)
                head = joints[9] + 1.0
                heads.append([head - 0.06 * side, head + 0.06 * side])
        for name, persons in people.items():
            _write_image(os.path.join(img_dir, name), smooth_image(rng, h, w),
                         np.concatenate([p for p, _ in persons]),
                         np.concatenate([v for _, v in persons]))
        with open(os.path.join(ann_dir, f'{split}.json'), 'w') as fp:
            json.dump(anno, fp)
    gt_mat = os.path.join(ann_dir, 'gt_valid.mat')
    savemat(gt_mat, {'dataset_joints': np.array([MPII_JOINT_NAMES], dtype=object),
                     'jnt_missing': 1 - np.stack(gt_vis, axis=1),
                     'pos_gt_src': np.stack(gt_joints, axis=2),
                     'headboxes_src': np.stack(heads, axis=2)})
    return img_dir, ann_dir, gt_mat


def coco_tree(root: str, rng: np.random.RandomState, *, dataset: str = 'mscoco',
              n_persons: int, image_size: Tuple[int, int] = (640, 480), per_image: int = 2,
              box: Tuple[float, float] = (0.5, 0.9)) -> Tuple[str, str]:
    """A COCO-format tree of `dataset` (mscoco: 17 keypoints; crowdpose: 14,
    its `crowdpose_{trainval,test}.json` and images in one directory;
    hands: 22) under `root`: each split holds `n_persons` persons,
    `per_image` side by side, box heights a share of the image's uniform in
    `box`, keypoints uniform in the box with COCO's flags (0 unlabelled,
    1 occluded, 2 visible); plus the three annotations a reader skips.
    Returns (image_path, annotation_path)."""
    from hourglass_pose_estimation_torch.data.common import REGISTRY
    cls = REGISTRY[dataset]
    J, w, h = cls.n_joints, image_size[0], image_size[1]
    img_root, ann_dir = os.path.join(root, 'images'), os.path.join(root, 'annotations')
    os.makedirs(ann_dir, exist_ok=True)
    ann_id = 0
    for split in (cls.train_set, cls.val_set):
        img_dir = os.path.join(img_root, split) if cls.images_in_set_subdir else img_root
        os.makedirs(img_dir, exist_ok=True)
        base = 1000 if split == cls.train_set else 0
        images, anns, people = {}, [], {}
        for i, (img_i, cx, slot_w) in enumerate(_slots(n_persons, per_image, w)):
            iid = base + img_i + 1
            images[iid] = {'id': iid, 'width': w, 'height': h, 'file_name': '%012d.jpg' % iid}
            bh = rng.uniform(*box) * h
            bw = min(0.5 * bh, 0.9 * slot_w)
            x0 = cx - bw / 2 + rng.uniform(-0.05, 0.05) * slot_w
            y0 = rng.uniform(0, h - bh)
            kx = x0 + rng.uniform(0.1, 0.9, size=J) * bw
            ky = y0 + rng.uniform(0.1, 0.9, size=J) * bh
            flag = rng.choice([0, 1, 2], size=J, p=[0.1, 0.2, 0.7])
            kps = np.stack([np.where(flag > 0, kx, 0.0), np.where(flag > 0, ky, 0.0), flag], 1)
            ann_id += 1
            anns.append({'id': ann_id, 'image_id': iid, 'iscrowd': 0, 'area': float(bw * bh),
                         'category_id': 1, 'bbox': [float(x0), float(y0), float(bw), float(bh)],
                         'num_keypoints': int((flag > 0).sum()),
                         'keypoints': [float(v) for v in kps.ravel()]})
            people.setdefault(iid, []).append(kps)
        first = next(iter(images))
        good = anns[0]
        for extra in ({'iscrowd': 1}, {'area': 0.0, 'bbox': [10.0, 10.0, 0.0, 0.0]},
                      {'keypoints': [0.0] * (3 * J), 'num_keypoints': 0}):
            ann_id += 1
            anns.append({**good, 'id': ann_id, 'image_id': first, **extra})
        for iid, persons in people.items():
            kps = np.concatenate(persons)
            _write_image(os.path.join(img_dir, images[iid]['file_name']),
                         smooth_image(rng, h, w), kps[:, :2], kps[:, 2])
        ann_name = (f'crowdpose_{split}.json' if dataset == 'crowdpose'
                    else f'{cls.ann_prefix}_{split}.json')
        with open(os.path.join(ann_dir, ann_name), 'w') as fp:
            json.dump({'images': list(images.values()), 'annotations': anns,
                       'categories': [{'id': 1, 'name': 'person'}]}, fp)
    return img_root, ann_dir
