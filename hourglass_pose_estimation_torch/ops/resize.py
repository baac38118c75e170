"""Bilinear resize with half-pixel centers (cv2 INTER_LINEAR parity).

Port of `hourglass_pose_estimation_tpu/ops/resize.py::
resize_bilinear_halfpix`: two 1-D interpolation products (H, then W)
against the same dense [out, in] weight matrices, in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix_halfpix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear weights with half-pixel centers:
    src = (dst+0.5)*in/out - 0.5, clamped to the valid range (cv2 border
    replication at the edges)."""
    m = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    for o in range(out_size):
        s = (o + 0.5) * scale - 0.5
        s = min(max(s, 0.0), in_size - 1.0)
        i0 = int(np.floor(s))
        i1 = min(i0 + 1, in_size - 1)
        f = s - i0
        m[o, i0] += 1.0 - f
        m[o, i1] += f
    return m


def resize_bilinear_halfpix(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, h, w, C], computed in f32 and returned in
    x's dtype."""
    B, H, W, C = x.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    if (H, W) == (h, w):
        return x
    mat = lambda i, o: torch.from_numpy(_interp_matrix_halfpix(i, o)).to(x.device)
    y = torch.einsum('hH,bHWc->bhWc', mat(H, h), x.to(torch.float32))
    y = torch.einsum('wW,bhWc->bhwc', mat(W, w), y)
    return y.to(x.dtype)
