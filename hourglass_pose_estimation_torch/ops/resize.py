"""Bilinear resizes: half-pixel centers (cv2 INTER_LINEAR parity) and
align-corners (the MSPN decoder's).

Port of `hourglass_pose_estimation_tpu/ops/resize.py::
resize_bilinear_halfpix` and `resize_bilinear_align_corners`: two 1-D
interpolation products (H, then W) against the same dense [out, in]
weight matrices, in f32, the result cast back to the input's dtype. Not
`F.interpolate`: its bf16 path rounds at other points than the JAX
function. The products are differentiable; autograd gives the transposed
products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] row-stochastic bilinear weights, align_corners=True:
    src = dst * (in-1) / (out-1)."""
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    for o in range(out_size):
        s = o * scale
        i0 = int(np.floor(s))
        i1 = min(i0 + 1, in_size - 1)
        f = s - i0
        m[o, i0] += 1.0 - f
        m[o, i1] += f
    return m


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


@functools.lru_cache(maxsize=128)
def _device_matrix(make, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`make(in_size, out_size)` on `device`, copied there once: a copy from
    pageable host memory in every forward would wait for the card. Made
    outside inference mode, so that a training forward can save it for its
    backward after an inference call made it."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(in_size, out_size)).to(device)


def _matrix(make, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`_device_matrix`, but made anew while `torch.export` traces (then it
    becomes a constant of the program; the tracer's tensor must not reach
    the cache that later eager calls read)."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(make(in_size, out_size)).to(device)
    return _device_matrix(make, in_size, out_size, device)


def _separable_resize(x: torch.Tensor, make, out_hw) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] with `make`'s weights: the H product,
    then the W product, in f32; the result in x's dtype (x itself when the
    sizes are equal)."""
    B, H, W, C = x.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    if (H, W) == (h, w):
        return x
    y = torch.einsum('hH,bHWc->bhWc', _matrix(make, H, h, x.device),
                     x.to(torch.float32))
    y = torch.einsum('wW,bhWc->bhwc', _matrix(make, W, w, x.device), y)
    return y.to(x.dtype)


def resize_bilinear_halfpix(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, h, w, C], computed in f32 and returned in
    x's dtype."""
    return _separable_resize(x, _interp_matrix_halfpix, out_hw)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, h, w, C], align_corners=True bilinear,
    computed in f32 and returned in x's dtype."""
    return _separable_resize(x, _interp_matrix, out_hw)
