"""Fused nearest-2x upsample + skip-add: Hopper kernel + plain version.

Port of the forward of `hourglass_pose_estimation_tpu/ops/pallas/
upsample.py::upsample2x_add_pallas`. The kernel is `csrc/upsample.cu`;
its header says what bounds it. The backward (a 2x2 block sum) comes
with the training slice.
"""

from __future__ import annotations

import torch

from hourglass_pose_estimation_torch.ops.hopper import _build


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NHWC [B, H, W, C]."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, 2 * H, 2 * W, C)


def upsample2x_add_reference(low: torch.Tensor,
                             skip: torch.Tensor) -> torch.Tensor:
    """Plain version: nearest2x(low) + skip."""
    return upsample2x_nearest(low) + skip


def upsample2x_add(low: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """nearest_upsample_2x(low) + skip, fused. low [B, H, W, C],
    skip [B, 2H, 2W, C], both NHWC.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in `upsample2x_add.launches`) or raises."""
    if low.device.type == 'cpu' and skip.device.type == 'cpu':
        return upsample2x_add_reference(low, skip)
    B, H, W, C = low.shape
    if (tuple(skip.shape) != (B, 2 * H, 2 * W, C) or low.dtype != skip.dtype
            or low.device != skip.device):
        raise ValueError(f'upsample2x_add: low {tuple(low.shape)} {low.dtype} '
                         f'{low.device}, skip {tuple(skip.shape)} {skip.dtype} '
                         f'{skip.device}')
    if low.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'upsample2x_add kernel: dtype {low.dtype}')
    esize = low.element_size()
    if (C * esize) % 16 != 0:
        raise ValueError(f'upsample2x_add kernel: C*{esize} bytes must be a '
                         f'multiple of 16, C={C}')
    if not (low.is_contiguous() and skip.is_contiguous()):
        raise ValueError('upsample2x_add kernel: low and skip must be '
                         'contiguous NHWC')
    out = torch.empty_like(skip)
    err = _build.library().hpe_upsample2x_add(
        low.data_ptr(), skip.data_ptr(), out.data_ptr(), B, H, W, C, esize,
        _build.num_sms(low), _build.stream_for(low))
    _build.check(err, 'upsample2x_add')
    upsample2x_add.launches += 1
    return out


upsample2x_add.launches = 0
