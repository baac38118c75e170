"""Fused pre-activation bottleneck (affine BN): Hopper kernel + plain version.

Port of `hourglass_pose_estimation_tpu/ops/pallas/bottleneck.py`
(`BottleneckParams`, `fold_bn`, `params_from_variables`,
`bottleneck_reference`, and the forward kernel `fused_bottleneck_pallas`).
The kernel is `csrc/bottleneck.cu`; its header says what bounds it and
how its design answers that.

Layouts are the JAX package's: x [B, H, W, C] (NHWC), w1 [C, P],
w2 [3, 3, P, P] (HWIO), w3 [P, C]. The kernel reads each weight
output-channel-major, which is the TRANSPOSE of those layouts;
`params_from_variables` stores every weight so that its transpose is a
contiguous view (`_n_major`), so the kernel path copies nothing per call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from hourglass_pose_estimation_torch.ops.hopper import _build

PLANES = 128          # the kernel's bottleneck width
MAX_SMEM = 232448     # bytes of shared memory one block may use on Hopper


class BottleneckParams(NamedTuple):
    """Folded parameters of one pre-act bottleneck (affine BN)."""
    a1: torch.Tensor   # [C]  bn1 scale
    b1: torch.Tensor   # [C]  bn1 shift
    w1: torch.Tensor   # [C, P]
    c1: torch.Tensor   # [P]  conv1 bias
    a2: torch.Tensor   # [P]
    b2: torch.Tensor   # [P]
    w2: torch.Tensor   # [3, 3, P, P]
    c2: torch.Tensor   # [P]
    a3: torch.Tensor   # [P]
    b3: torch.Tensor   # [P]
    w3: torch.Tensor   # [P, C]
    c3: torch.Tensor   # [C]


def fold_bn(gamma, beta, mean, var, eps=1e-5):
    """BatchNorm(running stats) -> per-channel affine (a, b)."""
    a = gamma / torch.sqrt(var + eps)
    return a, beta - mean * a


def _n_major(w: torch.Tensor) -> torch.Tensor:
    """Same values, stored so that w.transpose(-1, -2) is contiguous."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def _t(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device) if device is not None else v.detach()
    return torch.as_tensor(np.array(v), device=device)


def params_from_variables(block_vars, eps=1e-5, dtype=torch.bfloat16,
                          device=None) -> BottleneckParams:
    """JAX-layout Bottleneck variables -> BottleneckParams.

    block_vars = {'params': {...}, 'batch_stats': {...}} of one
    identity-residual, non-mobile `Bottleneck`, leaves as numpy arrays
    or tensors (conv kernels HWIO)."""
    p, s = block_vars['params'], block_vars['batch_stats']
    f32 = torch.float32
    leaf = lambda d, k: _t(d[k], device).to(f32)
    ab = [fold_bn(leaf(p[bn], 'scale'), leaf(p[bn], 'bias'),
                  leaf(s[bn], 'mean'), leaf(s[bn], 'var'), eps)
          for bn in ('bn1', 'bn2', 'bn3')]
    kern = lambda name: _n_major(_t(p[name]['kernel'], device).to(dtype))
    return BottleneckParams(
        a1=ab[0][0], b1=ab[0][1], w1=kern('conv1')[0, 0],
        c1=leaf(p['conv1'], 'bias'),
        a2=ab[1][0], b2=ab[1][1], w2=kern('conv2'),
        c2=leaf(p['conv2'], 'bias'),
        a3=ab[2][0], b3=ab[2][1], w3=kern('conv3')[0, 0],
        c3=leaf(p['conv3'], 'bias'))


def bottleneck_reference(x: torch.Tensor,
                         params: BottleneckParams) -> torch.Tensor:
    """The same affine-BN bottleneck as plain PyTorch ops (the kernel's
    plain version and the CPU path). Products take operands rounded to
    x.dtype and accumulate in f32, as `preferred_element_type=f32` does
    in the JAX reference."""
    f32, dt = torch.float32, x.dtype
    p = params
    rnd = lambda t: t.to(dt).to(f32)
    t1 = torch.relu(x.to(f32) * p.a1 + p.b1)
    h1 = rnd(t1) @ rnd(p.w1) + p.c1
    t2 = torch.relu(h1 * p.a2 + p.b2)
    w2 = rnd(p.w2).permute(3, 2, 0, 1)                   # HWIO -> OIHW
    h2 = F.conv2d(rnd(t2).permute(0, 3, 1, 2), w2, padding=1)
    h2 = h2.permute(0, 2, 3, 1) + p.c2
    t3 = torch.relu(h2 * p.a3 + p.b3)
    h3 = rnd(t3) @ rnd(p.w3) + p.c3
    return h3.to(dt) + x


@functools.lru_cache(maxsize=256)
def rows_per_block(batch: int, height: int, width: int, sms: int) -> int:
    """Output rows per CUDA block: the largest divisor of H whose t2
    window fits in shared memory, halved while the grid would leave SMs
    idle."""
    lib = _build.library()
    fits = [d for d in range(1, height + 1)
            if height % d == 0
            and lib.hpe_bottleneck_smem_bytes(width, d) <= MAX_SMEM]
    if not fits:
        raise ValueError(f'bottleneck kernel: width {width} too large for '
                         'shared memory')
    tr = fits[-1]
    while batch * (height // tr) < sms - 4 and tr % 2 == 0 and tr > 2:
        tr //= 2
    return tr


def _check_cuda(x: torch.Tensor, p: BottleneckParams):
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError('fused_bottleneck kernel: x must be a contiguous '
                         f'NHWC bf16 tensor, got {x.dtype} {tuple(x.shape)} '
                         f'strides {x.stride()}')
    C = x.shape[3]
    P = p.w1.shape[1]
    if P != PLANES or C % PLANES != 0 or tuple(p.w1.shape) != (C, P):
        raise ValueError(f'fused_bottleneck kernel: needs P={PLANES} and C a '
                         f'multiple of {PLANES}; got C={C}, w1 {tuple(p.w1.shape)}')
    shapes = dict(w2=(3, 3, P, P), w3=(P, C))
    for name, t in p._asdict().items():
        if t.device != x.device:
            raise ValueError(f'fused_bottleneck: {name} on {t.device}, '
                             f'x on {x.device}')
        if name.startswith('w'):
            if t.dtype != torch.bfloat16 or not t.transpose(-1, -2).is_contiguous():
                raise ValueError(f'fused_bottleneck kernel: {name} must be bf16 '
                                 'stored output-channel-major (build it with '
                                 'params_from_variables)')
            if name in shapes and tuple(t.shape) != shapes[name]:
                raise ValueError(f'fused_bottleneck: {name} shape {tuple(t.shape)}')
        elif t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f'fused_bottleneck kernel: {name} must be a '
                             'contiguous f32 vector')


def fused_bottleneck(x: torch.Tensor, params: BottleneckParams) -> torch.Tensor:
    """Fused bottleneck forward, x [B, H, W, C] NHWC, identity residual.

    A CPU tensor takes `bottleneck_reference`; a CUDA tensor launches the
    kernel (and counts the launch in `fused_bottleneck.launches`) or
    raises."""
    if x.device.type == 'cpu':
        return bottleneck_reference(x, params)
    _check_cuda(x, params)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    tr = rows_per_block(B, H, W, _build.num_sms(x))
    p = params
    ptr = lambda t: t.data_ptr()
    err = lib.hpe_bottleneck_fwd(
        ptr(x), ptr(out), ptr(p.a1), ptr(p.b1), ptr(p.w1), ptr(p.c1),
        ptr(p.a2), ptr(p.b2), ptr(p.w2), ptr(p.c2),
        ptr(p.a3), ptr(p.b3), ptr(p.w3), ptr(p.c3),
        B, H, W, C, PLANES, tr,
        _build.stream_for(x))
    _build.check(err, 'fused_bottleneck')
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
