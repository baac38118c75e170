"""Dataset core of the port: packed record arrays, the host (cv2)
pipeline, the canvas batches of the device pipeline, the epoch loader and
the dataset registry.

Port of `hourglass_pose_estimation_tpu/data/common.py`. A dataset is a
struct of numpy arrays (struct-of-arrays), its images either in memory or
files on disk, and there are two pipelines:

  * host (`host_batch`): the reference's augmentation on the host, drawn
    from a `np.random.RandomState` in its order, the crop warped by cv2;
    normalisation and target rendering then run on the device
    (`data/pipeline.py::prepare_host_batch`);
  * device (`canvas_batch`): the host only packs fixed-size uint8 canvases
    plus geometry; the draws, the crop warp, normalisation and rendering
    run on the device (`data/pipeline.py::augment_batch`).

Conventions kept from the reference: BGR channels, pixel_std = 200 scales,
one uniform draw gating both the flip (p <= 0.5) and the rotation
(p <= 0.6), scale jitter clip(randn * sf + 1, 1 - sf, 1 + sf), rotation
clip(randn * rf, +-2 rf). cv2 is imported only where an image file is
read or resized, so importing the port never loads it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hourglass_pose_estimation_torch.data.meanstd import get_meanstd
from hourglass_pose_estimation_torch.utils.transforms import (
    affine_transform, fliplr_joints, get_affine_transform)

PIXEL_STD = 200.0


@dataclasses.dataclass
class PoseRecords:
    """Struct-of-arrays for N person instances."""

    centers: np.ndarray               # [N, 2] f32
    scales: np.ndarray                # [N, 2] f32 (units of 200 px)
    joints: np.ndarray                # [N, J, 2] f32 (source-image coords)
    vis: np.ndarray                   # [N, J] f32
    widths: np.ndarray                # [N] f32 source-image widths (for flip)
    image_paths: Optional[List[str]] = None
    images: Optional[np.ndarray] = None   # [N, H, W, 3] uint8 (BGR), in-memory sets

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
        # canvas slots filled by each path: the native loader, cv2 (files),
        # memory (in-memory images)
        self.slot_paths = {'native': 0, 'cv2': 0, 'memory': 0}

    def _load_records(self) -> PoseRecords:
        raise NotImplementedError

    def _read_image(self, idx: int) -> np.ndarray:
        """The source image [H, W, 3] uint8 (BGR): in memory, or the file
        read by cv2 (EXIF orientation ignored, as the reference reads it).
        Raises ValueError on a file cv2 cannot read."""
        r = self.records
        if r.images is not None:
            return r.images[idx]
        import cv2
        img = cv2.imread(r.image_paths[idx], cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise ValueError(f'failed to read {r.image_paths[idx]}')
        return img

    def __len__(self):
        return len(self.records)

    # -- data selection and statistics
    def select_data(self) -> np.ndarray:
        """Indices of the records that pass the reference's OKS-like
        quality filter (its common.py select_data, vectorised): the visible
        joints' centroid near the box center relative to the box area,
        ks = exp(-d^2 / (0.2^2 * 2 * area)) above a threshold that grows
        with the visible joints."""
        r = self.records
        vis = r.vis > 0
        num_vis = vis.sum(axis=1)
        safe = np.maximum(num_vis, 1)[:, None]
        centroid = (r.joints * vis[..., None]).sum(axis=1) / safe
        area = r.scales[:, 0] * r.scales[:, 1] * (self.pixel_std ** 2)
        d2 = ((centroid - r.centers) ** 2).sum(axis=1)
        ks = np.exp(-d2 / (0.2 ** 2 * 2.0 * np.maximum(area, 1e-6)))
        metric = (0.2 / 16) * num_vis + 0.45 - 0.2 / 16
        keep = (num_vis > 0) & (ks > metric)
        return np.nonzero(keep)[0]

    def apply_selection(self, idxs: np.ndarray) -> None:
        """Restrict the records to `idxs` in place."""
        r = self.records
        self.records = PoseRecords(
            centers=r.centers[idxs], scales=r.scales[idxs],
            joints=r.joints[idxs], vis=r.vis[idxs], widths=r.widths[idxs],
            image_paths=([r.image_paths[i] for i in idxs]
                         if r.image_paths is not None else None),
            images=r.images[idxs] if r.images is not None else None)

    def compute_meanstd(self, max_samples: int = 512):
        """Channel (mean, std) of the first `max_samples` images in [0, 1]
        BGR: each image's mean and std (ddof 1), averaged over the images,
        as the reference's _compute_mean does."""
        n = min(len(self), max_samples)
        means, stds = [], []
        for i in range(n):
            flat = (self._read_image(i).astype(np.float64) / 255.0).reshape(-1, 3)
            means.append(flat.mean(axis=0))
            stds.append(flat.std(axis=0, ddof=1))
        return (tuple(np.mean(means, axis=0)), tuple(np.mean(stds, axis=0)))

    def flip_permutation(self) -> np.ndarray:
        """Joint permutation under a horizontal flip."""
        perm = np.arange(self.n_joints)
        for a, b in self.flip_pairs:
            perm[a], perm[b] = perm[b], perm[a]
        return perm

    # -- host (cv2) pipeline
    def host_sample(self, idx: int, rng: np.random.RandomState,
                    train: Optional[bool] = None) -> Dict[str, np.ndarray]:
        """One sample augmented on the host as the reference does (its
        common.py __getitem__): the draws from `rng` in its order, the flip
        about the image's own width, the crop by cv2.warpAffine
        (INTER_LINEAR) of the float64 affine. The crop stays uint8 [R, R, 3]
        BGR 0-255 (the JAX package widens it to f32 here, the same values;
        `prepare_host_batch` widens it on the device), the joints are in
        crop pixels."""
        import cv2
        train = self.is_train if train is None else train
        r = self.records
        img = self._read_image(idx)
        joints = np.concatenate([r.joints[idx].copy(), np.zeros((self.n_joints, 1))], axis=1)
        vis3 = np.stack([r.vis[idx]] * 3, axis=1).astype(np.float64)
        c = r.centers[idx].astype(np.float64).copy()
        s = r.scales[idx].astype(np.float64).copy()
        rot = 0.0
        if train:
            sf, rf = self.scale_factor, self.rot_factor
            prob = rng.random_sample()
            s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            rot = float(np.clip(rng.randn() * rf, -rf * 2, rf * 2)) if prob <= 0.6 else 0.0
            if prob <= 0.5:
                img = img[:, ::-1, :]
                joints, vis3 = fliplr_joints(joints, vis3, img.shape[1], self.flip_pairs)
                c[0] = img.shape[1] - c[0] - 1

        trans = get_affine_transform(c, s, rot, (self.inp_res, self.inp_res))
        crop = cv2.warpAffine(img, trans[:2].astype(np.float64), (self.inp_res, self.inp_res),
                              flags=cv2.INTER_LINEAR)
        for j in range(self.n_joints):
            if vis3[j, 0] > 0:
                joints[j, :2] = affine_transform(joints[j, :2], trans)
        return {
            'image': crop,                                # [R, R, 3] uint8 BGR
            'joints': joints[:, :2].astype(np.float32),   # input-crop coords
            'vis': vis3[:, 0].astype(np.float32),
            'center': c.astype(np.float32),
            'scale': s.astype(np.float32),
            'rotation': np.float32(rot),
            'index': np.int32(idx),
        }

    def host_batch(self, idxs: Sequence[int], rng: np.random.RandomState,
                   train: Optional[bool] = None) -> Dict[str, np.ndarray]:
        """`host_sample` of each index, in order, stacked."""
        samples = [self.host_sample(i, rng, train) for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    # -- device pipeline: raw canvases
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
            q = canvas / max(H, W) (cv2.resize, INTER_LINEAR, to
            round(W q) x round(H q)) and zero-padded bottom/right; the
            resize samples at half-pixel centers, so the content sits at
            q x_src + (q - 1) / 2 and the source offset recorded is
            (1 - q) / (2q), which makes the device warp's map
            x_canvas = q (x_src - o) the same map;
          * crop-aware: the person's reachable crop region (side from
            `_region_sides`) packed around its center, x_canvas =
            q (x_src - o) with q = min(1, canvas / side), sampled bilinearly
            with zeros outside the image.

        JPEG files take the native loader (data/native.py) where it is
        available; every slot it did not fill (other formats, a failed
        decode, no loader) takes cv2: warpAffine in crop mode, as the JAX
        package does, so file canvases are its bits. In-memory images take
        the numpy `warp_region` in crop mode (no cv2 needed). The width of
        each slot is read from its image (readers may defer it: MPII stores
        -1). `self.slot_paths` counts the slots each path filled."""
        r = self.records
        B = len(idxs)
        out = np.zeros((B, canvas, canvas, 3), np.uint8)
        qs = np.zeros((B,), np.float32)
        offs = np.zeros((B, 2), np.float32)
        widths = r.widths[idxs].astype(np.float32).copy()
        done = np.zeros((B,), bool)
        sides = self._region_sides(idxs) if crop_aware else None
        centers = r.centers[idxs].astype(np.float32)

        if r.images is None and r.image_paths is not None:
            jpeg_slots = [k for k, i in enumerate(idxs)
                          if r.image_paths[i].lower().endswith(('.jpg', '.jpeg'))]
            if jpeg_slots:
                from hourglass_pose_estimation_torch.data import native
                paths = [r.image_paths[idxs[k]] for k in jpeg_slots]
                if crop_aware:
                    res = native.load_region_batch(paths, canvas, centers[jpeg_slots],
                                                   sides[jpeg_slots])
                    if res is not None:
                        imgs, q, off, ws, ok = res
                        for j, k in enumerate(jpeg_slots):
                            if ok[j]:
                                out[k], qs[k], offs[k], widths[k] = imgs[j], q[j], off[j], ws[j]
                                done[k] = True
                else:
                    res = native.load_canvas_batch(paths, canvas)
                    if res is not None:
                        imgs, scales, ws, ok = res
                        for j, k in enumerate(jpeg_slots):
                            if ok[j]:
                                out[k], qs[k], widths[k] = imgs[j], scales[j], ws[j]
                                offs[k] = (1.0 - scales[j]) / (2.0 * scales[j])
                                done[k] = True
        n_native = int(done.sum())

        for k, i in enumerate(idxs):
            if done[k]:
                continue
            img = self._read_image(i)
            h, w = img.shape[:2]
            widths[k] = float(w)
            if crop_aware and sides[k] >= 8.0:
                side = float(sides[k])
                cx, cy = centers[k]
                ox = np.floor(cx - side * 0.5 + 0.5)
                oy = np.floor(cy - side * 0.5 + 0.5)
                q = min(1.0, canvas / side)
                if r.images is not None:
                    out[k] = warp_region(img, q, ox, oy, canvas)
                else:
                    import cv2
                    M = np.array([[q, 0.0, -q * ox], [0.0, q, -q * oy]], np.float64)
                    out[k] = cv2.warpAffine(img, M, (canvas, canvas), flags=cv2.INTER_LINEAR)
                qs[k] = q
                offs[k] = (ox, oy)
                continue
            q = canvas / max(h, w)
            if q != 1.0:
                import cv2
                img = cv2.resize(img, (int(round(w * q)), int(round(h * q))),
                                 interpolation=cv2.INTER_LINEAR)
            out[k, :img.shape[0], :img.shape[1]] = img
            qs[k] = q
            offs[k] = (1.0 - q) / (2.0 * q)
        where = 'memory' if r.images is not None else 'cv2'
        self.slot_paths['native'] += n_native
        self.slot_paths[where] += B - n_native
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


def register(cls):
    REGISTRY[cls.name] = cls
    return cls


def get_dataset(name: str, is_train: bool, **kwargs) -> PoseDataset:
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset '{name}'; available: {sorted(REGISTRY)}")
    return REGISTRY[name](is_train, **kwargs)
