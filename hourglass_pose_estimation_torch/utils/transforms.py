"""Person-crop affine geometry (the port's copy of
`hourglass_pose_estimation_tpu/utils/transforms.py`).

A person is a `center` (pixels) and a `scale` (person size / 200 px);
the network input is the similarity warp of that box onto an
`output_size` canvas, L = (W/w) R(-rot), t = dst_c - L src_c. Two halves:

  * host, numpy in float64 (`get_affine_transform`, `affine_transform`,
    `transform_preds`, `fliplr_joints`): one transform at a time, for the
    cv2 host pipeline and dataset bookkeeping;
  * device, batched f32 tensor math (`batched_affine_transforms`,
    `batched_apply_affine`): the device pipeline's crop affines.

The reference builds its affine from three point pairs
(`cv2.getAffineTransform`); both pairs' third points follow the same 90
degree rule, so that map is this similarity exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PIXEL_STD = 200.0


def _rot_mat(rot_deg: float) -> np.ndarray:
    r = np.pi * rot_deg / 180.0
    cs, sn = np.cos(r), np.sin(r)
    return np.array([[cs, -sn], [sn, cs]], dtype=np.float64)


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0), inv=False) -> np.ndarray:
    """2x3 float64 affine mapping the person box onto `output_size` (w, h);
    center (2,) source pixels, scale a scalar or (2,) in units of 200 px,
    rot degrees (counter-clockwise in image coordinates), shift a fraction
    of the box; inv=True gives the dst -> src map."""
    scale = np.asarray(scale, dtype=np.float64).reshape(-1)
    if scale.size == 1:
        scale = np.array([scale[0], scale[0]])
    center = np.asarray(center, dtype=np.float64)
    shift = np.asarray(shift, dtype=np.float64)

    src_w = scale[0] * PIXEL_STD
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    L = (dst_w / src_w) * _rot_mat(-rot)
    src_c = center + scale * PIXEL_STD * shift
    dst_c = np.array([dst_w * 0.5, dst_h * 0.5])
    if inv:
        Li = np.linalg.inv(L)
        t = src_c - Li @ dst_c
        return np.concatenate([Li, t[:, None]], axis=1)
    t = dst_c - L @ src_c
    return np.concatenate([L, t[:, None]], axis=1)


def affine_transform(pt, trans) -> np.ndarray:
    """Apply a 2x3 affine to one (x, y) point."""
    pt = np.asarray(pt, dtype=np.float64)
    return trans[:, :2] @ pt[:2] + trans[:, 2]


def transform_preds(coords, center, scale, output_size) -> np.ndarray:
    """Heatmap-space coords [..., 2] -> source-image pixels."""
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    coords = np.asarray(coords, dtype=np.float64)
    return coords @ trans[:, :2].T + trans[:, 2]


def fliplr_joints(joints, joints_vis, width, matched_parts):
    """Mirror joints [J, >=2] in an image `width` wide and swap the
    left/right pairs (with their visibilities); as the reference, the
    coordinates of invisible joints come out zeroed (joints * joints_vis)."""
    joints = np.array(joints, dtype=np.float64, copy=True)
    joints_vis = np.array(joints_vis, copy=True)
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints * joints_vis, joints_vis


def _apply_linear(L: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[B, 2, 2] x [B, ..., 2] -> [B, ..., 2] as elementwise math."""
    shape = pts.shape
    x, y = pts[..., 0], pts[..., 1]
    idx = (slice(None),) + (None,) * (len(shape) - 2)
    ox = L[idx + (0, 0)] * x + L[idx + (0, 1)] * y
    oy = L[idx + (1, 0)] * x + L[idx + (1, 1)] * y
    return torch.stack([ox, oy], dim=-1)


def batched_affine_transforms(centers, scales, rots, output_size,
                              shifts=None, inv=False) -> torch.Tensor:
    """Batch of 2x3 affines. centers [B, 2], scales [B] or [B, 2] (units
    of 200 px), rots [B] degrees, output_size (w, h), shifts [B, 2].
    inv=True builds the dst -> src transforms. Returns [B, 2, 3] f32."""
    f32 = torch.float32
    centers = torch.as_tensor(centers, dtype=f32)
    dev = centers.device
    scales = torch.as_tensor(scales, dtype=f32, device=dev)
    if scales.dim() == 1:
        scales = torch.stack([scales, scales], dim=-1)
    rots = torch.as_tensor(rots, dtype=f32, device=dev)
    B = centers.shape[0]
    if shifts is None:
        shifts = torch.zeros((B, 2), dtype=f32, device=dev)

    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_w = scales[:, 0] * PIXEL_STD
    k = dst_w / src_w
    r = -rots * (math.pi / 180.0)
    cs, sn = torch.cos(r), torch.sin(r)
    L = k[:, None, None] * torch.stack(
        [torch.stack([cs, -sn], -1), torch.stack([sn, cs], -1)], dim=-2)
    src_c = centers + scales * PIXEL_STD * shifts
    dst_c = torch.tensor([dst_w * 0.5, dst_h * 0.5], dtype=f32, device=dev)

    if inv:
        det = L[:, 0, 0] * L[:, 1, 1] - L[:, 0, 1] * L[:, 1, 0]
        Li = torch.stack([
            torch.stack([L[:, 1, 1], -L[:, 0, 1]], -1),
            torch.stack([-L[:, 1, 0], L[:, 0, 0]], -1),
        ], dim=-2) / det[:, None, None]
        t = src_c - _apply_linear(Li, dst_c.expand(src_c.shape))
        return torch.cat([Li, t[:, :, None]], dim=-1)
    t = dst_c - _apply_linear(L, src_c)
    return torch.cat([L, t[:, :, None]], dim=-1)


def batched_apply_affine(points, trans) -> torch.Tensor:
    """Apply [B, 2, 3] affines to [B, N, 2] points -> [B, N, 2]."""
    points = torch.as_tensor(points, dtype=torch.float32)
    return _apply_linear(trans[:, :, :2], points) + trans[:, None, :, 2]
