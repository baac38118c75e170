"""2x2 stride-2 max-pool and its backward in two modes: Hopper kernels +
plain versions.

Port of `hourglass_pose_estimation_tpu/ops/pallas/pool.py::
maxpool2x2_pallas` and its custom VJP. The kernels are `csrc/pool.cu`;
its header says what bounds them. The forward equals
`F.max_pool2d(x, 2, 2)` exactly. The backward recomputes the window max
and either splits g equally among tied maxima (`maxpool2x2_bwd`, the
Pallas convention, held to `maxpool2x2_pallas`) or gives all of g to the
first maximum in row-major order (`maxpool2x2_bwd_first`, the gradient of
the JAX model's `nn.max_pool` and of `F.max_pool2d`; the model's pools
take this one). Each kernel is a `torch.library` op (`hpe::maxpool2x2_fwd`,
`hpe::maxpool2x2_bwd`, `hpe::maxpool2x2_bwd_first`), the one route to it
in eager and under `torch.export` alike.
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


def maxpool2x2_bwd_first_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the first-maximum backward: dx = g at the first
    element of each window, in row-major order, that equals its max; 0
    elsewhere."""
    B, H, W, C = x.shape
    xw = _windows(x).permute(0, 1, 3, 5, 2, 4).reshape(B, H // 2, W // 2, C, 4)
    first = torch.nn.functional.one_hot(xw.argmax(dim=-1), 4).to(torch.bool)
    dx = torch.where(first, g[..., None].to(x.dtype), torch.zeros((), dtype=x.dtype))
    return (dx.reshape(B, H // 2, W // 2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
            .reshape(x.shape))


def _check_fwd(x: torch.Tensor) -> int:
    """What the forward kernel takes; -> element size."""
    _windows(x)
    return _check_vectors('maxpool2x2', x)


def _check_bwd(x: torch.Tensor, g: torch.Tensor, what: str) -> int:
    """What the backward kernel takes in either mode; -> element size."""
    B, H, W, C = x.shape
    _windows(x)
    if tuple(g.shape) != (B, H // 2, W // 2, C):
        raise ValueError(f'{what}: x {tuple(x.shape)}, g {tuple(g.shape)}')
    return _check_vectors(what, x, g)


def _bwd(x: torch.Tensor, g: torch.Tensor, first_max: bool) -> torch.Tensor:
    """Launch the backward kernel in one of its modes (CUDA tensors)."""
    B, H, W, C = x.shape
    what = 'maxpool2x2_bwd_first' if first_max else 'maxpool2x2_bwd'
    esize = _check_bwd(x, g, what)
    dx = torch.empty_like(x)
    err = _build.library().hpe_maxpool2x2_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), B, H, W, C, esize,
        int(first_max), _build.num_sms(x), _build.stream_for(x))
    _build.check(err, what)
    return dx


# The kernels as `torch.library` ops: the CPU kernel is the plain version,
# the CUDA kernel the launch (checks, counted on the public wrapper), and
# the fake gives the output's shape (and, given meta tensors, refuses what
# the CUDA kernel would).
@torch.library.custom_op('hpe::maxpool2x2_fwd', mutates_args=(), device_types='cpu')
def _fwd_op(x: torch.Tensor) -> torch.Tensor:
    return maxpool2x2_reference(x)


@_fwd_op.register_kernel('cuda')
def _(x):
    esize = _check_fwd(x)
    B, H, W, C = x.shape
    out = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    err = _build.library().hpe_maxpool2x2_fwd(
        x.data_ptr(), out.data_ptr(), B, H, W, C, esize, _build.num_sms(x),
        _build.stream_for(x))
    _build.check(err, 'maxpool2x2')
    maxpool2x2_fwd.launches += 1
    return out


@_fwd_op.register_fake
def _(x):
    if _build.on_meta(x):
        _check_fwd(x)
    B, H, W, C = x.shape
    return x.new_empty((B, H // 2, W // 2, C))


@torch.library.custom_op('hpe::maxpool2x2_bwd', mutates_args=(), device_types='cpu')
def _bwd_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return maxpool2x2_bwd_reference(x, g)


@_bwd_op.register_kernel('cuda')
def _(x, g):
    dx = _bwd(x, g, first_max=False)
    maxpool2x2_bwd.launches += 1
    return dx


@torch.library.custom_op('hpe::maxpool2x2_bwd_first', mutates_args=(), device_types='cpu')
def _bwd_first_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return maxpool2x2_bwd_first_reference(x, g)


@_bwd_first_op.register_kernel('cuda')
def _(x, g):
    dx = _bwd(x, g, first_max=True)
    maxpool2x2_bwd_first.launches += 1
    return dx


def _bwd_fake(what: str):
    def fake(x, g):
        if _build.on_meta(x, g):
            _check_bwd(x, g, what)
        return x.new_empty(x.shape)
    return fake


_bwd_op.register_fake(_bwd_fake('maxpool2x2_bwd'))
_bwd_first_op.register_fake(_bwd_fake('maxpool2x2_bwd_first'))


def maxpool2x2_fwd(x: torch.Tensor) -> torch.Tensor:
    """Forward, x [B, H, W, C] NHWC with H, W even -> [B, H/2, W/2, C] (the
    op `hpe::maxpool2x2_fwd`).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in `maxpool2x2_fwd.launches`) or raises."""
    return torch.ops.hpe.maxpool2x2_fwd(x)


def maxpool2x2_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward splitting ties, (x [B, H, W, C], g [B, H/2, W/2, C]) -> dx
    [B, H, W, C] (the op `hpe::maxpool2x2_bwd`).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `maxpool2x2_bwd.launches`) or raise."""
    return torch.ops.hpe.maxpool2x2_bwd(x, g)


def maxpool2x2_bwd_first(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward giving each window's g to its first maximum, with
    `maxpool2x2_bwd`'s arguments (the op `hpe::maxpool2x2_bwd_first`).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `maxpool2x2_bwd_first.launches`) or raise."""
    return torch.ops.hpe.maxpool2x2_bwd_first(x, g)


_BACKWARDS = {'split': maxpool2x2_bwd, 'first': maxpool2x2_bwd_first}


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ties):
        ctx.save_for_backward(x)
        ctx.backward_fn = _BACKWARDS[ties]
        return maxpool2x2_fwd(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return ctx.backward_fn(x, g.contiguous()), None


def maxpool2x2(x: torch.Tensor, ties: str = 'first') -> torch.Tensor:
    """Differentiable 2x2/2 max-pool of an NHWC tensor: `maxpool2x2_fwd`
    forward; backward `maxpool2x2_bwd_first` (ties='first', the model's:
    `nn.max_pool`'s gradient) or `maxpool2x2_bwd` (ties='split', the
    Pallas kernel's)."""
    if ties not in _BACKWARDS:
        raise ValueError(f"maxpool2x2: ties must be 'split' or 'first', got {ties!r}")
    return _MaxPool.apply(x, ties)


maxpool2x2_fwd.launches = 0
maxpool2x2_bwd.launches = 0
maxpool2x2_bwd_first.launches = 0
