"""Batched affine warp on the device (the person crop + augmentation
resample).

Port of `hourglass_pose_estimation_tpu/ops/warp.py::affine_warp` and
`affine_warp_separable` (XLA code there, plain tensor ops here): bilinear
sampling with cv2.warpAffine's BORDER_CONSTANT(0). The gather warp reads
the four taps of each destination pixel from the source zero-padded by a
2-pixel ring with clamped indices (any clamped tap lands in the ring),
and lerps top, bottom, then vertically, in the JAX package's order, so
uint8 sources give the same f32 values. The JAX package's byte packing
of the taps is a TPU gather optimisation and is not needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _source_coords(inv_trans: torch.Tensor, w: int, h: int):
    dev = inv_trans.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    t = inv_trans.to(torch.float32)[:, :, :, None, None]
    sx = t[:, 0, 0] * xs + t[:, 0, 1] * ys + t[:, 0, 2]     # [B, h, w]
    sy = t[:, 1, 0] * xs + t[:, 1, 1] * ys + t[:, 1, 2]
    return sx, sy


def affine_warp(images: torch.Tensor, inv_trans: torch.Tensor,
                out_size) -> torch.Tensor:
    """images [B, Hs, Ws, C] (uint8 or float), inv_trans [B, 2, 3]
    dst -> src, out_size (w, h) -> [B, h, w, C] f32, zero outside the
    source."""
    B, Hs, Ws, C = images.shape
    w, h = int(out_size[0]), int(out_size[1])
    sx, sy = _source_coords(inv_trans, w, h)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]

    P = F.pad(images.permute(0, 3, 1, 2), (2, 2, 2, 2)).permute(0, 2, 3, 1)
    Lw = Ws + 4
    flat = P.reshape(B, (Hs + 4) * Lw, C)
    xp = (x0.to(torch.int64) + 2).clamp(0, Ws + 2)
    yp = (y0.to(torch.int64) + 2).clamp(0, Hs + 2)
    idx = (yp * Lw + xp).reshape(B, h * w, 1).expand(B, h * w, C)
    tap = lambda off: torch.gather(flat, 1, idx + off).reshape(B, h, w, C).float()
    top = tap(0) * (1 - fx) + tap(1) * fx
    bot = tap(Lw) * (1 - fx) + tap(Lw + 1) * fx
    return top * (1 - fy) + bot * fy


def _axis_onehot(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """[B, n] f32 source coordinates -> [B, in_size, n] bilinear one-hot
    weights; taps outside the source get weight 0."""
    i0 = torch.floor(coords)
    f = (coords - i0)[:, None, :]
    taps = torch.arange(in_size, dtype=torch.float32,
                        device=coords.device)[None, :, None]
    i0 = i0[:, None, :]
    return (taps == i0) * (1.0 - f) + (taps == i0 + 1.0) * f


def affine_warp_separable(images: torch.Tensor, inv_trans: torch.Tensor,
                          out_size) -> torch.Tensor:
    """Axis-aligned warp (inv_trans[:, 0, 1] == inv_trans[:, 1, 0] == 0:
    scale, translation, flip) as a vertical then a horizontal 1-D
    bilinear resample, each a one-hot matrix product in f32. Equals
    `affine_warp` to f32 rounding."""
    B, Hs, Ws, C = images.shape
    w, h = int(out_size[0]), int(out_size[1])
    t = inv_trans.to(torch.float32)
    dev = t.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None]
    sx = t[:, 0, 0, None] * xs + t[:, 0, 2, None]          # [B, w]
    sy = t[:, 1, 1, None] * ys + t[:, 1, 2, None]          # [B, h]
    wy = _axis_onehot(sy, Hs)                              # [B, Hs, h]
    wx = _axis_onehot(sx, Ws)                              # [B, Ws, w]
    img = images.to(torch.float32)
    mid = torch.einsum('bYy,bYXc->byXc', wy, img)
    return torch.einsum('bXx,byXc->byxc', wx, mid)
