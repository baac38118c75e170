"""Gaussian heatmap target render: Hopper kernel + plain version.

Port of `hourglass_pose_estimation_tpu/ops/pallas/render.py::
render_gaussian_targets_pallas` (`_render_kernel`). The kernel is
`csrc/render.cu`; its header says what bounds it. Both versions start
from the integer peaks and weights of `ops/heatmap.py::render_preamble`.
"""

from __future__ import annotations

import numpy as np
import torch

from hourglass_pose_estimation_torch.ops.hopper import _build


def render_gaussian_reference(mu: torch.Tensor, weight: torch.Tensor,
                              heatmap_size, sigma) -> torch.Tensor:
    """Plain version: mu [B, J, 2] int32, weight [B, J] f32 ->
    [B, Hh, Wh, J] f32, exp(-(dx^2 + dy^2) / 2 sigma^2) inside the
    (6 sigma + 1)-wide window of an active (weight > 0.5) joint, else 0."""
    Wh, Hh = int(heatmap_size[0]), int(heatmap_size[1])
    tmp = int(3 * sigma)
    dev = mu.device
    xs = torch.arange(Wh, dtype=torch.int32, device=dev)
    ys = torch.arange(Hh, dtype=torch.int32, device=dev)
    dx = xs[None, None, :, None] - mu[:, None, None, :, 0]        # [B, 1, W, J]
    dy = ys[None, :, None, None] - mu[:, None, None, :, 1]        # [B, H, 1, J]
    g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2) / (2.0 * float(sigma) ** 2))
    in_window = (dx.abs() <= tmp) & (dy.abs() <= tmp)
    active = (weight > 0.5)[:, None, None, :]
    return torch.where(in_window & active, g, torch.zeros((), device=dev))


def render_gaussian(mu: torch.Tensor, weight: torch.Tensor, heatmap_size,
                    sigma) -> torch.Tensor:
    """mu [B, J, 2] int32, weight [B, J] f32 -> target [B, Hh, Wh, J] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `render_gaussian.launches`) or raise."""
    if mu.device.type == 'cpu' and weight.device.type == 'cpu':
        return render_gaussian_reference(mu, weight, heatmap_size, sigma)
    B, J = weight.shape
    if (mu.dtype != torch.int32 or weight.dtype != torch.float32
            or tuple(mu.shape) != (B, J, 2) or mu.device != weight.device
            or not (mu.is_contiguous() and weight.is_contiguous())):
        raise ValueError('render_gaussian kernel: mu must be contiguous int32 '
                         f'[B, J, 2] and weight f32 [B, J] on one device; got '
                         f'{mu.dtype} {tuple(mu.shape)} {mu.device}, '
                         f'{weight.dtype} {tuple(weight.shape)} {weight.device}')
    Wh, Hh = int(heatmap_size[0]), int(heatmap_size[1])
    out = torch.empty((B, Hh, Wh, J), dtype=torch.float32, device=mu.device)
    err = _build.library().hpe_render_gaussian(
        mu.data_ptr(), weight.data_ptr(), out.data_ptr(), B, Hh, Wh, J,
        int(3 * sigma), float(np.float32(2.0 * float(sigma) ** 2)),
        _build.num_sms(mu), _build.stream_for(mu))
    _build.check(err, 'render_gaussian')
    render_gaussian.launches += 1
    return out


render_gaussian.launches = 0
