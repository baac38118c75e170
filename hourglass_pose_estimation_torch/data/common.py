"""Dataset core of the port: packed record arrays, the canvas batches of
the device pipeline, the epoch loader and the dataset registry.

Port of the in-memory part of `hourglass_pose_estimation_tpu/data/
common.py` (`PoseRecords`, `PoseDataset.flip_permutation`,
`PoseDataset.canvas_batch` in both packing modes, `Loader`, `REGISTRY`,
`register`, `get_dataset`): a dataset is a struct of numpy arrays, and the
host only packs fixed-size uint8 canvases plus geometry; flips, scale and
rotation draws, the crop warp, normalisation and target rendering run on
the device (`data/pipeline.py`). Image files, the native JPEG loader, the
whole-image resize (cv2) and the cv2 host pipeline come with the host-data
slice (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

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

    def _region_sides(self, idxs) -> np.ndarray:
        """Side of the square source region the augmented crop can
        sample: s*200 grown by the max scale jitter (train) and the
        rotated square's bounding box (sqrt 2 covers any angle), plus a
        bilinear-tap margin."""
        r = self.records
        s = np.max(r.scales[idxs], axis=-1) * self.pixel_std
        margin = (1.0 + self.scale_factor) * np.sqrt(2.0) \
            if self.is_train else 1.0
        return (s * margin + 4.0).astype(np.float32)

    def canvas_batch(self, idxs: Sequence[int], canvas: int = 512,
                     crop_aware: bool = False) -> Dict[str, np.ndarray]:
        """Fixed-size uint8 canvases + geometry for on-device augmentation.

          * whole-image (default): the source image scaled by
            q = canvas / max(H, W) and zero-padded bottom/right, with the
            half-pixel source offset (1 - q) / (2q). Only q = 1 is ported:
            any other q is cv2's INTER_LINEAR resize (host-data slice);
          * crop-aware: the person's reachable crop region (side from
            `_region_sides`) packed around its center, x_canvas =
            q * (x_src - o) with q = min(1, canvas / side), sampled
            bilinearly with zeros outside the image (`warp_region`)."""
        r = self.records
        B = len(idxs)
        out = np.zeros((B, canvas, canvas, 3), np.uint8)
        qs = np.zeros((B,), np.float32)
        offs = np.zeros((B, 2), np.float32)
        widths = r.widths[idxs].astype(np.float32).copy()
        sides = self._region_sides(idxs) if crop_aware else None
        centers = r.centers[idxs].astype(np.float32)
        for k, i in enumerate(idxs):
            img = r.images[i]
            h, w = img.shape[:2]
            widths[k] = float(w)
            if crop_aware and sides[k] >= 8.0:
                side = float(sides[k])
                cx, cy = centers[k]
                ox = np.floor(cx - side * 0.5 + 0.5)
                oy = np.floor(cy - side * 0.5 + 0.5)
                q = min(1.0, canvas / side)
                out[k] = warp_region(img, q, ox, oy, canvas)
                qs[k] = q
                offs[k] = (ox, oy)
                continue
            q = canvas / max(h, w)
            if q != 1.0:
                raise NotImplementedError(
                    f'canvas_batch: a {h}x{w} image into a {canvas} canvas needs '
                    f"cv2's resize (q={q:.3f}); only q = 1 is ported (ROADMAP "
                    'Queue 1 item 9)')
            out[k, :h, :w] = img
            qs[k] = q
            offs[k] = (1.0 - q) / (2.0 * q)
        return {
            'canvas': out,
            'canvas_scale': qs,
            'canvas_offset': offs,
            'center': centers,
            'scale': r.scales[idxs].astype(np.float32),
            'joints': r.joints[idxs].astype(np.float32),
            'vis': r.vis[idxs].astype(np.float32),
            'width': widths,
            'index': np.asarray(idxs, np.int32),
        }


def warp_region(img: np.ndarray, q: float, ox: float, oy: float,
                canvas: int) -> np.ndarray:
    """uint8 [canvas, canvas, 3] with canvas pixel (x, y) sampled
    bilinearly at source (x / q + ox, y / q + oy), zero outside the image:
    `cv2.warpAffine(img, [[q, 0, -q ox], [0, q, -q oy]], INTER_LINEAR)`
    in float32 arithmetic. The JAX package calls cv2, whose rounding of
    the taps' weights differs: within 1 level at ~1e-4 of the values.

    The map is axis-aligned, so the interpolation runs as a pass along x
    over the source rows and then one along y, which is the same float32
    arithmetic in the same order as the 2-D formula
    ((p00 (1-fx) + p01 fx) (1-fy) + (p10 (1-fx) + p11 fx) fy)."""
    f32 = np.float32
    # the inverse affine as cv2 forms it, in float64, then float32
    m = np.array([q, 0.0, -q * ox, 0.0, q, -q * oy])
    d = 1.0 / (m[0] * m[4] - m[1] * m[3])
    m[0], m[1], m[3], m[4] = m[4] * d, m[1] * -d, m[3] * -d, m[0] * d
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    m = m.astype(f32)
    t = np.arange(canvas, dtype=f32)
    h, w = img.shape[:2]

    def taps(coord, n):
        """Clipped lower and upper tap indices and their weights, each
        weight zero where its tap is off the image (a product with it is
        then +0, as the zero tap's would be)."""
        i0 = np.floor(coord)
        f = coord - i0
        i0 = i0.astype(np.int64)
        i1 = i0 + 1
        zero = f32(0)
        return ((np.clip(i0, 0, n - 1), np.clip(i1, 0, n - 1)),
                (np.where((i0 >= 0) & (i0 < n), f32(1) - f, zero),
                 np.where((i1 >= 0) & (i1 < n), f, zero)))

    (x0, x1), (wx0, wx1) = taps(m[0] * t + m[2], w)
    (y0, y1), (wy0, wy1) = taps(m[4] * t + m[5], h)
    src = img.astype(f32)
    rows = np.take(src, x0, axis=1)
    rows *= wx0[None, :, None]
    rows += np.take(src, x1, axis=1) * wx1[None, :, None]          # [h, canvas, 3]
    v = np.take(rows, y0, axis=0)
    v *= wy0[:, None, None]
    v += np.take(rows, y1, axis=0) * wy1[:, None, None]
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


class Loader:
    """Epoch iterator over batches of indices (static batch shapes).

    Training drops the ragged tail; evaluation pads the final batch by
    repeating the last index and returns a validity mask so metrics ignore
    padding. The shuffle order comes from a `RandomState(seed)` made at
    construction, so each epoch draws the next permutation of one stream
    (the JAX package's order, index for index)."""

    def __init__(self, dataset: PoseDataset, batch_size: int, *,
                 shuffle: bool, seed: int = 0, drop_last: bool = True,
                 shard: Tuple[int, int] = (0, 1)):
        """shard=(process_index, process_count): `batch_size` stays the
        GLOBAL batch; every process sees the same steps and the same
        global order, but each batch yields only this process's contiguous
        batch_size / process_count rows."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.shard_i, self.shard_n = int(shard[0]), int(shard[1])
        if self.batch_size % self.shard_n:
            raise ValueError(f'batch_size {batch_size} must divide by '
                             f'process_count {self.shard_n}')

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(indices int64 [b], valid f32 [b]), ...] for one epoch."""
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        batches = []
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            valid = np.ones((self.batch_size,), np.float32)
            if len(idx) < self.batch_size:
                pad = self.batch_size - len(idx)
                valid[len(idx):] = 0.0
                idx = np.concatenate([idx, np.full((pad,), idx[-1] if len(idx) else 0)])
            if self.shard_n > 1:
                k = self.batch_size // self.shard_n
                lo = self.shard_i * k
                idx, valid = idx[lo:lo + k], valid[lo:lo + k]
            batches.append((idx.astype(np.int64), valid))
        return batches


# registry filled by dataset modules
REGISTRY: Dict[str, type] = {}
# datasets of the JAX package whose readers come with the host-data slice
UNPORTED = ('mpii', 'mscoco', 'crowdpose', 'hands')


def register(cls):
    REGISTRY[cls.name] = cls
    return cls


def get_dataset(name: str, is_train: bool, **kwargs) -> PoseDataset:
    if name in UNPORTED:
        raise NotImplementedError(
            f"dataset '{name}': its reader is not ported yet (ROADMAP Queue 1 "
            "item 9); DATASET.name=synthetic runs in memory")
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset '{name}'; available: {sorted(REGISTRY)}")
    return REGISTRY[name](is_train, **kwargs)
