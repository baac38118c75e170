"""Batched person-crop affine geometry on device (the port's copy of the
device half of `hourglass_pose_estimation_tpu/utils/transforms.py`).

A person is a `center` (pixels) and a `scale` (person size / 200 px);
the network input is the similarity warp of that box onto an
`output_size` canvas. The transform is built in closed form,
L = (W/w) R(-rot), t = dst_c - L src_c, as f32 tensor math.
"""

from __future__ import annotations

import math

import torch

PIXEL_STD = 200.0


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
