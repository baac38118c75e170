"""Fused pre-activation bottleneck (affine BN): Hopper kernels + plain version.

Port of `hourglass_pose_estimation_tpu/ops/pallas/bottleneck.py`
(`BottleneckParams`, `fold_bn`, `params_from_variables`,
`bottleneck_reference`, the forward kernels `fused_bottleneck_pallas` with
its two schedules, `impl='image'` and `impl='chunked'`, and the custom VJP
`fused_bottleneck` with its explicit backward
`bottleneck_backward_reference`). The kernels are `csrc/bottleneck.cu`:
the image schedule as a thread-block cluster per image
(`fused_bottleneck_image`), the chunked one as independent row tiles that
recompute their halo (`fused_bottleneck_chunked`). Both run one Hopper
core: a producer warpgroup streams the weights through a TMA ring in
shared memory (multicast over the cluster in the image schedule), and two
consumer warpgroups run `wgmma` with A from registers; the source's header
says what bounds them and how the design answers that. Each schedule is a
`torch.library` op (`hpe::fused_bottleneck_image`,
`hpe::fused_bottleneck_chunked`), the one route to it in eager and under
`torch.export` alike. The tile choosers
(`rows_per_block`, `image_schedule`) size a block's row tile from the
kernel's shared-memory budget (`hpe_bottleneck_smem_bytes`: the t2 window
and the weight ring). `DEFAULT_IMPL` picks the schedule wherever the
caller names none, as in the JAX package. The backward is plain PyTorch
ops, as it is XLA in the JAX package.

The kernels take bf16 only, with P = PLANES and C = 2 * PLANES (the
identity residual's width); `models/modules.py` routes only such blocks
here.

Layouts are the JAX package's: x [B, H, W, C] (NHWC), w1 [C, P],
w2 [3, 3, P, P] (HWIO), w3 [P, C]. The kernels read each weight
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
MAX_CLUSTER = 8       # blocks in a portable thread-block cluster
IMPLS = ('image', 'chunked')
# The schedule `fused_bottleneck` runs where the caller names none; read at
# each call, so setting this module attribute switches every call site, as
# the JAX package's module-level DEFAULT_IMPL does. 'chunked' from the H100's
# times at the flagship shapes weighted by the launches of one forward
# (17 at 64^2, 24 at 32^2, 24 at 16^2; chip_smoke.py prints both sums):
# 10.65 ms against 13.12. At 64^2 the image schedule needs clusters of 8
# blocks of 8 rows, which fit 15 at once (120 of 132 SMs) and wait on
# their slowest block for every multicast weight tile; the chunked kernel's
# 512 blocks of 8 rows each run on their own.
DEFAULT_IMPL = 'chunked'


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
        return v.to(device) if device is not None else v
    return torch.as_tensor(np.array(v), device=device)


def params_from_variables(block_vars, eps=1e-5, dtype=torch.bfloat16,
                          device=None) -> BottleneckParams:
    """JAX-layout Bottleneck variables -> BottleneckParams.

    block_vars = {'params': {...}, 'batch_stats': {...}} of one
    identity-residual, non-mobile `Bottleneck`, leaves as numpy arrays
    or tensors (conv kernels HWIO). Differentiable: with tensors that
    require grad, the folded parameters carry the graph back to them, as
    the JAX fold does for the frozen-BN train step."""
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


def _fill(batch: int, height: int, tr: int, sms: int, ok) -> int:
    """Halve the row tile tr (while `ok(tr // 2)`) as long as the grid
    would leave SMs idle."""
    while batch * (height // tr) < sms - 4 and tr % 2 == 0 and tr > 2 and ok(tr // 2):
        tr //= 2
    return tr


@functools.lru_cache(maxsize=256)
def rows_per_block(batch: int, height: int, width: int, sms: int) -> int:
    """Output rows per CUDA block of the chunked kernel: the largest divisor
    of H whose t2 window and weight ring fit in shared memory, halved while
    the grid would leave SMs idle. On an H100 at batch 64 the largest tile
    was the fastest: TR 8 at 64^2 (0.449 ms against 0.461 at TR 4), TR 16
    at 32^2 (0.115 against 0.118 at TR 8); each halving adds 2/TR of
    conv1's work in halo rows."""
    lib = _build.library()
    fits = [d for d in range(1, height + 1)
            if height % d == 0
            and lib.hpe_bottleneck_smem_bytes(width, d) <= MAX_SMEM]
    if not fits:
        raise ValueError(f'bottleneck kernel: width {width} too large for '
                         'shared memory')
    return _fill(batch, height, fits[-1], sms, lambda tr: True)


@functools.lru_cache(maxsize=256)
def image_schedule(batch: int, height: int, width: int, sms: int) -> tuple:
    """(TR, R) of the cluster kernel: R = H / TR blocks per image, TR the
    largest divisor of H whose t2 window and weight ring fit in shared
    memory with R <= MAX_CLUSTER, halved (R doubled, up to MAX_CLUSTER)
    while the grid would leave SMs idle, as the chunked kernel's row tile
    is. Larger clusters share each multicast weight tile among more blocks
    but wait on the slowest of them; on an H100 at batch 64 the tile this
    picks was the fastest of every R <= 8 at 32^2 and 16^2."""
    lib = _build.library()
    ok = lambda d: height // d <= MAX_CLUSTER
    fits = [d for d in range(1, height + 1)
            if height % d == 0 and ok(d)
            and lib.hpe_bottleneck_smem_bytes(width, d) <= MAX_SMEM]
    if not fits:
        raise ValueError(
            f"fused_bottleneck impl='image': no row tile of a {height}x{width} "
            f'image fits its t2 window in shared memory with at most '
            f"{MAX_CLUSTER} blocks per cluster; use impl='chunked'")
    tr = _fill(batch, height, fits[-1], sms, ok)
    return tr, height // tr


@functools.lru_cache(maxsize=64)
def max_active_clusters(width: int, tr: int, r: int, device: int) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel at (W, TR, R)
    on CUDA device `device`."""
    import ctypes
    import torch
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(_build.library().hpe_bottleneck_image_max_clusters(
            width, tr, r, ctypes.byref(n)), 'cudaOccupancyMaxActiveClusters')
    return n.value


def _check_cuda(x: torch.Tensor, p: BottleneckParams):
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError('fused_bottleneck kernel: x must be a contiguous '
                         f'NHWC bf16 tensor, got {x.dtype} {tuple(x.shape)} '
                         f'strides {x.stride()}')
    C = x.shape[3]
    P = p.w1.shape[1]
    if P != PLANES or C != 2 * PLANES or tuple(p.w1.shape) != (C, P):
        raise ValueError(f'fused_bottleneck kernel: needs P={PLANES} and '
                         f'C={2 * PLANES}; got C={C}, w1 {tuple(p.w1.shape)}')
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


def _kernel_args(x: torch.Tensor, params: BottleneckParams, out: torch.Tensor):
    p = params
    return [t.data_ptr() for t in (x, out, p.a1, p.b1, p.w1, p.c1, p.a2, p.b2,
                                   p.w2, p.c2, p.a3, p.b3, p.w3, p.c3)]


# The two schedules as `torch.library` ops, `hpe::fused_bottleneck_image`
# and `hpe::fused_bottleneck_chunked`, taking x and the 12 folded tensors
# in BottleneckParams order: the CPU kernel is `bottleneck_reference`, the
# CUDA kernel the launch (schedule, checks, counted on the public
# wrapper), and the fake gives the output's shape (and, given meta
# tensors, refuses what the CUDA kernel would). `torch.export` keeps one
# node a block, whose folded tensors it reads as constants.
def _image_launch(x: torch.Tensor, p: BottleneckParams) -> torch.Tensor:
    _check_cuda(x, p)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tr, r = image_schedule(B, H, W, _build.num_sms(x))
    if max_active_clusters(W, tr, r, x.device.index) < 1:
        raise ValueError(f"fused_bottleneck impl='image': no cluster of {r} "
                         f'blocks with {W}-pixel rows fits on this card; use '
                         "impl='chunked'")
    err = _build.library().hpe_bottleneck_image_fwd(
        *_kernel_args(x, p, out), B, H, W, C, PLANES, tr, _build.stream_for(x))
    _build.check(err, 'fused_bottleneck_image')
    fused_bottleneck_image.launches += 1
    return out


def _chunked_launch(x: torch.Tensor, p: BottleneckParams) -> torch.Tensor:
    _check_cuda(x, p)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tr = rows_per_block(B, H, W, _build.num_sms(x))
    err = _build.library().hpe_bottleneck_fwd(
        *_kernel_args(x, p, out), B, H, W, C, PLANES, tr, _build.stream_for(x))
    _build.check(err, 'fused_bottleneck_chunked')
    fused_bottleneck_chunked.launches += 1
    return out


def _fake(x, *params):
    if _build.on_meta(x, *params):
        _check_cuda(x, BottleneckParams(*params))
    return x.new_empty(x.shape)


_SCHEMA = ('(Tensor x, ' + ', '.join(f'Tensor {n}' for n in BottleneckParams._fields)
           + ') -> Tensor')


def _define_op(name: str, launch):
    op = torch.library.custom_op(
        f'hpe::{name}', lambda x, *p: bottleneck_reference(x, BottleneckParams(*p)),
        mutates_args=(), device_types='cpu', schema=_SCHEMA)
    op.register_kernel('cuda')(lambda x, *p: launch(x, BottleneckParams(*p)))
    op.register_fake(_fake)


_define_op('fused_bottleneck_image', _image_launch)
_define_op('fused_bottleneck_chunked', _chunked_launch)


def fused_bottleneck_image(x: torch.Tensor, params: BottleneckParams) -> torch.Tensor:
    """Forward, impl 'image' (the op `hpe::fused_bottleneck_image`): the
    cluster kernel for a CUDA tensor (counted in
    `fused_bottleneck_image.launches`), `bottleneck_reference` for a CPU
    one. Raises ValueError where no cluster of at most MAX_CLUSTER blocks
    holds the image, or none can be resident on the card."""
    return torch.ops.hpe.fused_bottleneck_image(x, *params)


def fused_bottleneck_chunked(x: torch.Tensor, params: BottleneckParams) -> torch.Tensor:
    """Forward, impl 'chunked' (the op `hpe::fused_bottleneck_chunked`): the
    row-tile kernel for a CUDA tensor (counted in
    `fused_bottleneck_chunked.launches`), `bottleneck_reference` for a CPU
    one."""
    return torch.ops.hpe.fused_bottleneck_chunked(x, *params)


_FORWARD = {'image': fused_bottleneck_image, 'chunked': fused_bottleneck_chunked}


def resolve_impl(impl=None) -> str:
    """`impl`, or DEFAULT_IMPL when it is None; anything else raises."""
    impl = impl or DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'image' or 'chunked', got {impl!r}")
    return impl


def bottleneck_backward_reference(x: torch.Tensor, params: BottleneckParams,
                                  g: torch.Tensor):
    """Explicit VJP of the affine-BN bottleneck: (dx, dparams).

    Rematerialises the activations from x and computes every gradient
    with operands rounded to x.dtype and f32 accumulation (the products
    run in f32 on the rounded operands), ReLU masks at u > 0, as
    `bottleneck_backward_reference` of the JAX package does. Each
    gradient is returned in its parameter's dtype, dx in x's."""
    f32, xd = torch.float32, x.dtype
    p = params
    B, H, W, C = x.shape
    P = p.w1.shape[1]
    rnd = lambda t: t.to(xd).to(f32)
    nchw = lambda t: t.permute(0, 3, 1, 2)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    red = lambda t: t.sum(dim=(0, 1, 2))
    mm = lambda a, b: a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])

    # --- recompute the forward activations
    xf = x.to(f32)
    t1f = torch.relu(xf * p.a1 + p.b1)
    t1 = rnd(t1f)
    h1 = t1 @ rnd(p.w1) + p.c1
    u2 = h1 * p.a2 + p.b2
    t2 = rnd(torch.relu(u2))
    w2 = rnd(p.w2)                                         # HWIO
    h2 = nhwc(F.conv2d(nchw(t2), w2.permute(3, 2, 0, 1), padding=1)) + p.c2
    u3 = h2 * p.a3 + p.b3
    t3 = rnd(torch.relu(u3))

    # --- conv3 (1x1, P -> C) and bn3
    gf = g.to(f32)
    gc = rnd(g)
    dw3 = mm(t3, gc)                                       # [P, C]
    dc3 = red(gf)
    dt3 = gc @ rnd(p.w3).t()
    du3 = torch.where(u3 > 0, dt3, 0.0)
    da3, db3 = red(du3 * h2), red(du3)
    dh2 = du3 * p.a3

    # --- conv2 (3x3, P -> P) and bn2
    dh2c = rnd(dh2)
    t2p = F.pad(t2, (0, 0, 1, 1, 1, 1))
    dw2 = torch.stack([torch.stack([mm(t2p[:, ky:ky + H, kx:kx + W], dh2c)
                                    for kx in range(3)]) for ky in range(3)])
    dc2 = red(dh2)
    # transposed conv: correlation with the flipped, in/out-swapped kernel
    w2t = w2.flip(0, 1).permute(0, 1, 3, 2)                # HWIO of the transpose
    dt2 = nhwc(F.conv2d(nchw(dh2c), w2t.permute(3, 2, 0, 1), padding=1))
    du2 = torch.where(u2 > 0, dt2, 0.0)
    da2, db2 = red(du2 * h1), red(du2)
    dh1 = du2 * p.a2

    # --- conv1 (1x1, C -> P) and bn1
    dh1c = rnd(dh1)
    dw1 = mm(t1, dh1c)                                     # [C, P]
    dc1 = red(dh1)
    dt1 = dh1c @ rnd(p.w1).t()
    du1 = torch.where(t1f > 0, dt1, 0.0)
    da1, db1 = red(du1 * xf), red(du1)
    dx = (du1 * p.a1 + gf).to(xd)

    grads = dict(a1=da1, b1=db1, w1=dw1, c1=dc1, a2=da2, b2=db2, w2=dw2,
                 c2=dc2, a3=da3, b3=db3, w3=dw3, c3=dc3)
    return dx, BottleneckParams(**{k: grads[k].to(getattr(p, k).dtype)
                                   for k in BottleneckParams._fields})


class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, impl, *params):
        ctx.save_for_backward(x, *params)
        return _FORWARD[impl](x, BottleneckParams(*params))

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx, dp = bottleneck_backward_reference(x, BottleneckParams(*params), g)
        fused_bottleneck.backward_calls += 1
        return (dx, None, *dp)


def fused_bottleneck(x: torch.Tensor, params: BottleneckParams,
                     impl: str = None) -> torch.Tensor:
    """Fused bottleneck, x [B, H, W, C] NHWC, identity residual;
    differentiable in x and in every folded parameter.

    Forward: `impl` ('image' or 'chunked', DEFAULT_IMPL when None) picks
    the schedule: a CPU tensor takes `bottleneck_reference` under either; a
    CUDA tensor launches that schedule's kernel (`fused_bottleneck_image`
    or `fused_bottleneck_chunked`, each counting its launches) or raises.
    Backward: `bottleneck_backward_reference` (plain ops, rematerialising
    from x), counted in `fused_bottleneck.backward_calls`."""
    return _FusedBottleneck.apply(x, resolve_impl(impl), *params)


fused_bottleneck_image.launches = 0
fused_bottleneck_chunked.launches = 0
fused_bottleneck.backward_calls = 0
