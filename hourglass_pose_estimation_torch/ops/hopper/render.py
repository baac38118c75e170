"""Gaussian heatmap target render: Hopper kernel + plain version.

Port of `hourglass_pose_estimation_tpu/ops/pallas/render.py::
render_gaussian_targets_pallas` (`_render_kernel`). The kernel is
`csrc/render.cu`; its header says what bounds it. Both versions start
from the integer peaks and weights of `ops/heatmap.py::render_preamble`. The kernel is the `torch.library` op
`hpe::render_gaussian`, the one route to it in eager and under
`torch.export` alike.
"""

from __future__ import annotations

import numpy as np
import torch

from hourglass_pose_estimation_torch.ops.hopper import _build
from hourglass_pose_estimation_torch.utils import tracing


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


def _check_render(mu: torch.Tensor, weight: torch.Tensor) -> None:
    """What the kernel takes."""
    B, J = weight.shape
    if (mu.dtype != torch.int32 or weight.dtype != torch.float32
            or tuple(mu.shape) != (B, J, 2) or mu.device != weight.device
            or not (mu.is_contiguous() and weight.is_contiguous())):
        raise ValueError('render_gaussian kernel: mu must be contiguous int32 '
                         f'[B, J, 2] and weight f32 [B, J] on one device; got '
                         f'{mu.dtype} {tuple(mu.shape)} {mu.device}, '
                         f'{weight.dtype} {tuple(weight.shape)} {weight.device}')


# The kernel as the `torch.library` op `hpe::render_gaussian`: the CPU
# kernel is the plain version, the CUDA kernel the launch (checks, counted
# on the public wrapper), and the fake gives the output's shape (and, given
# meta tensors, refuses what the CUDA kernel would).
@torch.library.custom_op('hpe::render_gaussian', mutates_args=(), device_types='cpu')
def _render_op(mu: torch.Tensor, weight: torch.Tensor, width: int, height: int,
               sigma: float) -> torch.Tensor:
    return render_gaussian_reference(mu, weight, (width, height), sigma)


@_render_op.register_kernel('cuda')
def _(mu, weight, width, height, sigma):
    _check_render(mu, weight)
    B, J = weight.shape
    out = torch.empty((B, height, width, J), dtype=torch.float32, device=mu.device)
    err = _build.library().hpe_render_gaussian(
        mu.data_ptr(), weight.data_ptr(), out.data_ptr(), B, height, width, J,
        int(3 * sigma), float(np.float32(2.0 * sigma ** 2)),
        _build.num_sms(mu), _build.stream_for(mu))
    _build.check(err, 'render_gaussian')
    tracing.count('launches.render_gaussian')
    return out


@_render_op.register_fake
def _(mu, weight, width, height, sigma):
    if _build.on_meta(mu, weight):
        _check_render(mu, weight)
    B, J = weight.shape
    return weight.new_empty((B, height, width, J))


def render_gaussian(mu: torch.Tensor, weight: torch.Tensor, heatmap_size,
                    sigma) -> torch.Tensor:
    """mu [B, J, 2] int32, weight [B, J] f32 -> target [B, Hh, Wh, J] f32
    (the op `hpe::render_gaussian`).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in tracing's `launches.render_gaussian`) or raise."""
    return torch.ops.hpe.render_gaussian(mu, weight, int(heatmap_size[0]),
                                         int(heatmap_size[1]), float(sigma))
