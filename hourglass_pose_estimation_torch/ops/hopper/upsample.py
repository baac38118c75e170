"""Fused nearest-2x upsample + skip-add: Hopper kernels + plain versions.

Port of `hourglass_pose_estimation_tpu/ops/pallas/upsample.py::
upsample2x_add_pallas` and its custom VJP. The kernels are
`csrc/upsample.cu` (forward, and the backward of `low`, a 2x2 block sum);
its header says what bounds them. Each is a `torch.library` op,
`hpe::upsample2x_add` and `hpe::upsample2x_add_bwd`, the one route to it
in eager and under `torch.export` alike. `upsample2x_add` is
differentiable: d_skip = g, d_low = `upsample2x_add_bwd(g)`.
"""

from __future__ import annotations

import torch

from hourglass_pose_estimation_torch.ops.hopper import _build
from hourglass_pose_estimation_torch.utils import tracing


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NHWC [B, H, W, C]."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, 2 * H, 2 * W, C)


def upsample2x_add_reference(low: torch.Tensor,
                             skip: torch.Tensor) -> torch.Tensor:
    """Plain version: nearest2x(low) + skip."""
    return upsample2x_nearest(low) + skip


def upsample2x_add_bwd_reference(g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward of low: the 2x2 block sum of g
    [B, 2H, 2W, C] -> [B, H, W, C], summed in f32 in the kernel's order
    ((g00 + g01) + g10) + g11 and rounded once to g's dtype."""
    B, H2, W2, C = g.shape
    t = g.float().reshape(B, H2 // 2, 2, W2 // 2, 2, C)
    s = ((t[:, :, 0, :, 0] + t[:, :, 0, :, 1]) + t[:, :, 1, :, 0]) + t[:, :, 1, :, 1]
    return s.to(g.dtype)


def _check_vectors(name: str, *ts: torch.Tensor) -> int:
    """The conditions the 16-byte-vector kernels share; -> element size."""
    t = ts[0]
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'{name} kernel: dtype {t.dtype}')
    if any(u.dtype != t.dtype or u.device != t.device for u in ts):
        raise ValueError(f'{name}: ' + ', '.join(
            f'{tuple(u.shape)} {u.dtype} {u.device}' for u in ts))
    esize = t.element_size()
    if (t.shape[-1] * esize) % 16 != 0:
        raise ValueError(f'{name} kernel: C*{esize} bytes must be a '
                         f'multiple of 16, C={t.shape[-1]}')
    if not all(u.is_contiguous() for u in ts):
        raise ValueError(f'{name} kernel: tensors must be contiguous NHWC')
    return esize


def _check_upsample(low: torch.Tensor, skip: torch.Tensor) -> int:
    """What the forward kernel takes; -> element size."""
    B, H, W, C = low.shape
    if tuple(skip.shape) != (B, 2 * H, 2 * W, C):
        raise ValueError(f'upsample2x_add: low {tuple(low.shape)}, '
                         f'skip {tuple(skip.shape)}')
    return _check_vectors('upsample2x_add', low, skip)


def _check_upsample_bwd(g: torch.Tensor) -> int:
    """What the backward kernel takes; -> element size."""
    if g.shape[1] % 2 or g.shape[2] % 2:
        raise ValueError(f'upsample2x_add_bwd: odd g {tuple(g.shape)}')
    return _check_vectors('upsample2x_add_bwd', g)


# The kernels as `torch.library` ops: the CPU kernel is the plain version,
# the CUDA kernel the launch (checks, counted on the public wrapper), and
# the fake gives the output's shape (and, given meta tensors, refuses what
# the CUDA kernel would). `torch.export` keeps one `hpe::` node a call.
@torch.library.custom_op('hpe::upsample2x_add', mutates_args=(), device_types='cpu')
def _upsample2x_add_op(low: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    return upsample2x_add_reference(low, skip)


@_upsample2x_add_op.register_kernel('cuda')
def _(low, skip):
    esize = _check_upsample(low, skip)
    B, H, W, C = low.shape
    out = torch.empty_like(skip)
    err = _build.library().hpe_upsample2x_add(
        low.data_ptr(), skip.data_ptr(), out.data_ptr(), B, H, W, C, esize,
        _build.num_sms(low), _build.stream_for(low))
    _build.check(err, 'upsample2x_add')
    tracing.count('launches.upsample2x_add')
    return out


@_upsample2x_add_op.register_fake
def _(low, skip):
    if _build.on_meta(low, skip):
        _check_upsample(low, skip)
    return skip.new_empty(skip.shape)


@torch.library.custom_op('hpe::upsample2x_add_bwd', mutates_args=(), device_types='cpu')
def _upsample2x_add_bwd_op(g: torch.Tensor) -> torch.Tensor:
    return upsample2x_add_bwd_reference(g)


@_upsample2x_add_bwd_op.register_kernel('cuda')
def _(g):
    esize = _check_upsample_bwd(g)
    B, H2, W2, C = g.shape
    dlow = torch.empty((B, H2 // 2, W2 // 2, C), dtype=g.dtype, device=g.device)
    err = _build.library().hpe_upsample2x_add_bwd(
        g.data_ptr(), dlow.data_ptr(), B, H2 // 2, W2 // 2, C, esize,
        _build.num_sms(g), _build.stream_for(g))
    _build.check(err, 'upsample2x_add_bwd')
    tracing.count('launches.upsample2x_add_bwd')
    return dlow


@_upsample2x_add_bwd_op.register_fake
def _(g):
    if _build.on_meta(g):
        _check_upsample_bwd(g)
    B, H2, W2, C = g.shape
    return g.new_empty((B, H2 // 2, W2 // 2, C))


def upsample2x_add_bwd(g: torch.Tensor) -> torch.Tensor:
    """Backward of low: g [B, 2H, 2W, C] -> d_low [B, H, W, C] (the op
    `hpe::upsample2x_add_bwd`).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in tracing's `launches.upsample2x_add_bwd`) or raises."""
    return torch.ops.hpe.upsample2x_add_bwd(g)


class _UpsampleAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, low, skip):
        return torch.ops.hpe.upsample2x_add(low, skip)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return upsample2x_add_bwd(g), g


def upsample2x_add(low: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """nearest_upsample_2x(low) + skip, fused and differentiable. low
    [B, H, W, C], skip [B, 2H, 2W, C], both NHWC, one dtype.

    CPU tensors take the plain versions; CUDA tensors launch the forward
    kernel (the op `hpe::upsample2x_add`, counted in tracing's
    `launches.upsample2x_add`) and, in the backward, `upsample2x_add_bwd`,
    or raise."""
    return _UpsampleAdd.apply(low, skip)
