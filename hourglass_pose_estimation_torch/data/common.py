"""Dataset core of the port: packed record arrays and the canvas batches
of the device pipeline.

Port of the in-memory, whole-image part of `hourglass_pose_estimation_tpu/
data/common.py` (`PoseRecords`, `PoseDataset.flip_permutation`,
`PoseDataset.canvas_batch`): a dataset is a struct of numpy arrays, and
the host only packs fixed-size uint8 canvases plus geometry; flips,
scale and rotation draws, the crop warp, normalisation and target
rendering run on the device (`data/pipeline.py`). Image files, the
native JPEG loader, crop-aware packing and the cv2 host pipeline come
with the host-data slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from hourglass_pose_estimation_torch.data.meanstd import get_meanstd

PIXEL_STD = 200.0


@dataclasses.dataclass
class PoseRecords:
    """Struct-of-arrays for N person instances held in memory."""

    centers: np.ndarray               # [N, 2] f32
    scales: np.ndarray                # [N, 2] f32 (units of 200 px)
    joints: np.ndarray                # [N, J, 2] f32 (source-image coords)
    vis: np.ndarray                   # [N, J] f32
    widths: np.ndarray                # [N] f32 source-image widths (for flip)
    images: np.ndarray                # [N, H, W, 3] uint8 (BGR)

    def __len__(self):
        return self.centers.shape[0]


class PoseDataset:
    """Base dataset: subclasses fill `records`, `flip_pairs`, `n_joints`."""

    name: str = 'base'
    n_joints: int = 0
    flip_pairs: Sequence[Sequence[int]] = ()
    pixel_std: float = PIXEL_STD

    def __init__(self, is_train: bool, *, inp_res=256, out_res=64, sigma=1,
                 scale_factor=0.25, rot_factor=30, **_unused):
        self.is_train = is_train
        self.inp_res = int(inp_res)
        self.out_res = int(out_res)
        self.sigma = int(sigma)
        self.scale_factor = float(scale_factor)
        self.rot_factor = float(rot_factor)
        self.mean, self.std = get_meanstd(self.name)
        self.records: PoseRecords = self._load_records()

    def _load_records(self) -> PoseRecords:
        raise NotImplementedError

    def __len__(self):
        return len(self.records)

    def flip_permutation(self) -> np.ndarray:
        """Joint permutation under a horizontal flip."""
        perm = np.arange(self.n_joints)
        for a, b in self.flip_pairs:
            perm[a], perm[b] = perm[b], perm[a]
        return perm

    def canvas_batch(self, idxs: Sequence[int],
                     canvas: int = 512) -> Dict[str, np.ndarray]:
        """Fixed-size uint8 canvases + geometry for on-device augmentation:
        each source image scaled by q = canvas / max(H, W) and zero-padded
        bottom/right, with the half-pixel source offset (1 - q) / (2q).
        Only q = 1 is ported: resizing into the canvas is cv2's
        INTER_LINEAR resize, which comes with the host-data slice."""
        r = self.records
        B = len(idxs)
        out = np.zeros((B, canvas, canvas, 3), np.uint8)
        qs = np.zeros((B,), np.float32)
        offs = np.zeros((B, 2), np.float32)
        widths = r.widths[idxs].astype(np.float32).copy()
        for k, i in enumerate(idxs):
            img = r.images[i]
            h, w = img.shape[:2]
            widths[k] = float(w)
            q = canvas / max(h, w)
            if q != 1.0:
                raise NotImplementedError(
                    f'canvas_batch: a {h}x{w} image into a {canvas} canvas needs '
                    "cv2's resize (q={q:.3f}); only q = 1 is ported")
            out[k, :h, :w] = img
            qs[k] = q
            offs[k] = (1.0 - q) / (2.0 * q)
        return {
            'canvas': out,
            'canvas_scale': qs,
            'canvas_offset': offs,
            'center': r.centers[idxs].astype(np.float32),
            'scale': r.scales[idxs].astype(np.float32),
            'joints': r.joints[idxs].astype(np.float32),
            'vis': r.vis[idxs].astype(np.float32),
            'width': widths,
            'index': np.asarray(idxs, np.int32),
        }
