"""2x2 stride-2 max-pool with a tie-splitting backward: Hopper kernels +
plain versions.

Port of `hourglass_pose_estimation_tpu/ops/pallas/pool.py::
maxpool2x2_pallas` and its custom VJP. The kernels are `csrc/pool.cu`;
its header says what bounds them. The forward equals
`F.max_pool2d(x, 2, 2)` exactly; the backward recomputes the window max
and splits g equally among tied maxima (the Pallas convention; PyTorch's
pool backward routes it to one of them).
"""

from __future__ import annotations

import torch

from hourglass_pose_estimation_torch.ops.hopper import _build
from hourglass_pose_estimation_torch.ops.hopper.upsample import _check_vectors


def _windows(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(f'maxpool2x2: H and W must be even, got {tuple(x.shape)}')
    return x.reshape(B, H // 2, 2, W // 2, 2, C)


def maxpool2x2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, H, W, C] -> [B, H/2, W/2, C] window max."""
    return _windows(x).amax(dim=(2, 4))


def maxpool2x2_bwd_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: dx = g / ties * [x == window max],
    divided in f32 and rounded once to x's dtype."""
    xw = _windows(x)
    mask = xw == xw.amax(dim=(2, 4), keepdim=True)
    ties = mask.sum(dim=(2, 4), keepdim=True, dtype=torch.float32)
    dx = g.float()[:, :, None, :, None, :] / ties * mask
    return dx.to(x.dtype).reshape(x.shape)


def maxpool2x2_fwd(x: torch.Tensor) -> torch.Tensor:
    """Forward, x [B, H, W, C] NHWC with H, W even -> [B, H/2, W/2, C].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in `maxpool2x2_fwd.launches`) or raises."""
    if x.device.type == 'cpu':
        return maxpool2x2_reference(x)
    B, H, W, C = x.shape
    _windows(x)
    esize = _check_vectors('maxpool2x2', x)
    out = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    err = _build.library().hpe_maxpool2x2_fwd(
        x.data_ptr(), out.data_ptr(), B, H, W, C, esize, _build.num_sms(x),
        _build.stream_for(x))
    _build.check(err, 'maxpool2x2')
    maxpool2x2_fwd.launches += 1
    return out


def maxpool2x2_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward, (x [B, H, W, C], g [B, H/2, W/2, C]) -> dx [B, H, W, C].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `maxpool2x2_bwd.launches`) or raise."""
    if x.device.type == 'cpu' and g.device.type == 'cpu':
        return maxpool2x2_bwd_reference(x, g)
    B, H, W, C = x.shape
    _windows(x)
    if tuple(g.shape) != (B, H // 2, W // 2, C):
        raise ValueError(f'maxpool2x2_bwd: x {tuple(x.shape)}, g {tuple(g.shape)}')
    esize = _check_vectors('maxpool2x2_bwd', x, g)
    dx = torch.empty_like(x)
    err = _build.library().hpe_maxpool2x2_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), B, H, W, C, esize,
        _build.num_sms(x), _build.stream_for(x))
    _build.check(err, 'maxpool2x2_bwd')
    maxpool2x2_bwd.launches += 1
    return dx


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return maxpool2x2_fwd(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return maxpool2x2_bwd(x, g.contiguous())


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x2/2 max-pool of an NHWC tensor: `maxpool2x2_fwd`
    forward, `maxpool2x2_bwd` backward."""
    return _MaxPool.apply(x)


maxpool2x2_fwd.launches = 0
maxpool2x2_bwd.launches = 0
