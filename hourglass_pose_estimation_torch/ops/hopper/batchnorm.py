"""Train-mode BatchNorm with the ReLU and the cast fused in: Hopper kernels +
plain versions.

Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
fuses it into its neighbours. It was added because on the card the port's
train step spent most of its device time in the chain of generic
elementwise and reduce kernels that the plain math makes (~22 launches and
~66 bytes an element forward, ~20 launches and ~100 bytes back, for a bf16
activation). The kernels are `csrc/batchnorm.cu`; its header gives the
formulas. The byte bound of a bf16 activation of N elements is 6N forward
(x read by the statistics and by the apply, y written) and 10N back (dy and
x read by the reduction and by dx, dx written), plus the per-channel
vectors and the reductions' partial sums. The design meets it by reading
16-byte vectors of 8 channels, normalising, applying the ReLU and rounding
to the output dtype in one pass, keeping every statistic and gradient
reduction in f32 registers and shared memory, and saving for the backward
only the input and two f32 vectors a channel (the moments), not f32
copies of the activation.

Four ops, one kernel each, registered here as `torch.library` ops (CPU
kernel: the plain version; CUDA kernel: the launch; a fake for shapes):

  * `hpe::batch_norm_train_stats` (`bn_stats_kernel`): the moments [2, C]
    (sum x, sum x^2) / count_stats over the statistics' rows;
  * `hpe::batch_norm_train_fwd` (`bn_apply_kernel`): y, mean, var from the
    moments, and the running averages moved in place when given;
  * `hpe::batch_norm_train_bwd_reduce` (`bn_bwd_reduce_kernel`): dweight,
    dbias and the moments' cotangent;
  * `hpe::batch_norm_train_bwd` (`bn_bwd_dx_kernel`): dx.

`batch_norm_train` is their autograd Function: two launches forward and
two back, with the data group's all-reduce (`StatRows.sync`) of the
moments between the forward pair and of their cotangent between the
backward pair. `StatRows` carries every row rule of the model's BatchNorm
(`models/norm.py`): the whole local batch, its first k samples, and rows
synced over the data group as an average of the ranks' moments or as sums
of the global batch's first k rows (`global_rows`). The module's hooks
stay its own: it passes the weight and bias `_affine` gives, and the
running buffers only when `_update_running` is BatchNorm's own (an
override gets (mean, var)).

The plain versions are the ops' CPU kernels, so the Function is the
model's one-pass train-mode BatchNorm on every device (`models/norm.py`;
its eval mode and two-pass variance normalise with
`batch_norm_reference`): the moments, the statistics from them, the
normalisation with the ReLU and the cast, and the running update. The
backward ops' plain versions write out the gradient of that math, term by
term as autograd forms it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hourglass_pose_estimation_torch.ops.hopper import _build
from hourglass_pose_estimation_torch.utils import tracing

AXES = (0, 2, 3)
# the reduce kernels split C into chunks of 64 channels, one ticket each, of
# TICKETS (csrc/batchnorm.cu: kReduceColv, kMaxChunks)
TICKETS = 256
MAX_CHANNELS = TICKETS * 64


def batch_moments_reference(x: torch.Tensor, samples: int, count: float) -> torch.Tensor:
    """Plain version of the statistics: [2, C] (sum of x, sum of x^2) over
    the first `samples` samples of x [B, C, H, W], each / count, in f32 (or
    x's dtype, if wider)."""
    sdt = torch.promote_types(torch.float32, x.dtype)
    xs = x[:samples].to(sdt)
    return torch.stack([xs.sum(dim=AXES), xs.square().sum(dim=AXES)]) / count


def batch_stats_reference(moments: torch.Tensor, count: float):
    """(mean, biased variance) from the moments: mean = moments[0] / count,
    var = max(moments[1] / count - mean^2, 0) (the one-pass form)."""
    mean, mean2 = moments / count
    return mean, torch.clamp_min(mean2 - mean.square(), 0.0)


def batch_norm_reference(x: torch.Tensor, mean, var, weight, bias, eps: float,
                         relu: bool = False, out_dtype=None) -> torch.Tensor:
    """Plain version of the normalisation: relu?((x - mean) * (weight *
    rsqrt(var + eps)) + bias) over dim 1 of x (any memory format), in f32
    (or x's dtype, if wider), cast to out_dtype when given."""
    sdt = torch.promote_types(torch.float32, x.dtype)
    shape = (1, -1, 1, 1)
    mul = weight.to(sdt) * torch.rsqrt(var.to(sdt) + eps)
    y = ((x.to(sdt) - mean.to(sdt).view(shape))
         * mul.view(shape) + bias.to(sdt).view(shape))
    if relu:
        y = torch.relu(y)
    return y if out_dtype is None else y.to(out_dtype)


@torch.no_grad()
def running_update_reference(running_mean: torch.Tensor, running_var: torch.Tensor,
                             mean: torch.Tensor, var: torch.Tensor, momentum: float) -> None:
    """The running averages, in place: m * running + (1 - m) * batch."""
    m = momentum
    running_mean.copy_(m * running_mean + (1.0 - m) * mean)
    running_var.copy_(m * running_var + (1.0 - m) * var)


def _grad_parts(g, x, moments, weight, bias, count, eps, relu):
    """The backward's shared terms in f32 (or wider): (x - mean, the
    gradient that reaches the normalisation, mul, and the statistics)."""
    sdt = torch.promote_types(torch.float32, x.dtype)
    shape = (1, -1, 1, 1)
    mean, mean2 = moments / count
    raw = mean2 - mean.square()
    r = torch.rsqrt(torch.clamp_min(raw, 0.0) + eps)
    mul = weight * r
    xc = x.to(sdt) - mean.view(shape)
    dy = g.to(sdt)
    if relu:
        # relu's backward passes the gradient where its output is not <= 0
        dy = torch.where(xc * mul.view(shape) + bias.view(shape) <= 0, 0.0, dy)
    return xc, dy, mul, mean, raw, r


def batch_norm_bwd_reduce_reference(g, x, moments, weight, bias, count: float, eps: float,
                                    relu: bool):
    """Plain version of the backward reduction -> (dweight, dbias, the
    moments' cotangent [2, C]): the gradient of the plain normalisation of
    `batch_stats_reference(moments, count)` (dy masked by the ReLU; rsqrt's
    backward -0.5 g r^3; clamp_min's passes where E[x^2] - mean^2 >= 0)."""
    xc, dy, mul, mean, raw, r = _grad_parts(g, x, moments, weight, bias, count, eps, relu)
    sd, sdx = dy.sum(dim=AXES), (dy * xc).sum(dim=AXES)
    dvar = torch.where(raw >= 0, -0.5 * (sdx * weight) * r.pow(3), 0.0)
    dmean = -(mul * sd) - 2.0 * mean * dvar
    return sdx * r, sd, torch.stack([dmean, dvar]) / count


def batch_norm_bwd_reference(g, x, moments, weight, bias, cot, samples: int,
                             count_stats: float, count: float, eps: float,
                             relu: bool) -> torch.Tensor:
    """Plain version of dx, in x's dtype: dy * mul on every row, plus the
    moments' part, cot[0] / count_stats + 2 x cot[1] / count_stats, on the
    first `samples` samples (the rows the moments summed). Each part is
    rounded to x's dtype before the sum, as autograd and JAX round the
    cotangents of the two casts of x (the kernel sums in f32 and rounds
    once: the same in f32, within a bf16 step in bf16)."""
    xc, dy, mul, _, _, _ = _grad_parts(g, x, moments, weight, bias, count, eps, relu)
    dx = (dy * mul.view(1, -1, 1, 1)).to(x.dtype)
    c1, c2 = (cot / count_stats).view(2, 1, -1, 1, 1)
    dx[:samples] += (c1 + 2.0 * c2 * x[:samples].to(xc.dtype)).to(x.dtype)
    return dx


# --- what the kernels take

def _check_act(name: str, *ts: torch.Tensor) -> None:
    """Raise unless the kernels take each activation: [B, C, H, W], bf16 or
    f32, channels-last contiguous from a 16-byte boundary, C a multiple of
    8 up to MAX_CHANNELS, all of one shape on one device."""
    x = ts[0]
    for t in ts:
        if t.dim() != 4:
            raise ValueError(f'{name} kernel: x must be [B, C, H, W], got {tuple(t.shape)}')
        if t.shape[1] % 8 or t.shape[1] > MAX_CHANNELS:
            raise ValueError(f'{name} kernel: C must be a multiple of 8 up to {MAX_CHANNELS}, '
                             f'got {t.shape[1]}')
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f'{name} kernel: dtype {t.dtype}')
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f'{name} kernel: tensors must be channels-last contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} kernel: tensors must start on 16 bytes')
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f'{name}: {tuple(t.shape)} {t.device} against x '
                             f'{tuple(x.shape)} {x.device}')


def _check_vec(name: str, x: torch.Tensor, *vs: torch.Tensor) -> None:
    """Per-channel vectors ([C] or [2, C]): f32, contiguous, on x's device."""
    C = x.shape[1]
    for v in vs:
        if (v.dtype != torch.float32 or v.shape[-1] != C or v.dim() > 2
                or not v.is_contiguous() or v.device != x.device):
            raise ValueError(f'{name}: per-channel vector {tuple(v.shape)} {v.dtype} '
                             f'{v.device}, want f32 [.., {C}] contiguous on {x.device}')


def _samples(name: str, x: torch.Tensor, samples: int) -> int:
    if not 0 <= samples <= x.shape[0]:
        raise ValueError(f'{name}: samples {samples} of a batch of {x.shape[0]}')
    return samples


_tickets = {}


def _tickets_for(x: torch.Tensor, stream: int) -> torch.Tensor:
    """The reduce kernels' zeroed tickets for x's device and `stream` (the
    kernels leave them zeroed; launches on one stream run in turn)."""
    key = (x.device.index, stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(TICKETS, dtype=torch.int32, device=x.device)
    return t


def _partial(lib, x: torch.Tensor, rows: int):
    """(blocks, their [blocks, 2, C] f32 scratch) of a reduce kernel."""
    C = x.shape[1]
    blocks = lib.hpe_bn_reduce_blocks(rows, C, _build.num_sms(x))
    return blocks, torch.empty((blocks, 2, C), dtype=torch.float32, device=x.device)


def _vec(x: torch.Tensor, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=x.device)


# --- the ops. Registered through `torch.library.Library` (a CPU kernel, a
# CUDA kernel and a fake each) rather than `torch.library.custom_op`, whose
# Python wrapper costs ~20 us a call: these run four times a BatchNorm and
# step, 1416 calls a step in the flagship, whose step the host's dispatch
# paces. They have no autograd kernel: `batch_norm_train`'s Function calls
# them, with grad off.

_LIB = torch.library.Library('hpe', 'FRAGMENT')
_LIB.define('batch_norm_train_stats(Tensor x, int samples, float count_stats) -> Tensor')
_LIB.define('batch_norm_train_fwd(Tensor x, Tensor moments, Tensor weight, Tensor bias, '
            'Tensor(a!)? running_mean, Tensor(b!)? running_var, float count, float momentum, '
            'float eps, bool relu, ScalarType out_dtype) -> (Tensor, Tensor, Tensor)')
_LIB.define('batch_norm_train_bwd_reduce(Tensor g, Tensor x, Tensor moments, Tensor weight, '
            'Tensor bias, float count, float eps, bool relu) -> (Tensor, Tensor, Tensor)')
_LIB.define('batch_norm_train_bwd(Tensor g, Tensor x, Tensor moments, Tensor weight, '
            'Tensor bias, Tensor cot, int samples, float count_stats, float count, float eps, '
            'bool relu) -> Tensor')


def _stats_cpu(x, samples, count_stats):
    return batch_moments_reference(x, samples, count_stats)


def _stats_cuda(x, samples, count_stats):
    what = 'batch_norm_train_stats'
    _check_act(what, x)
    rows = _samples(what, x, samples) * x.shape[2] * x.shape[3]
    lib, stream = _build.library(), _build.stream_for(x)
    blocks, partial = _partial(lib, x, rows)
    moments = _vec(x, 2, x.shape[1])
    err = lib.hpe_bn_stats(x.data_ptr(), rows, x.shape[1], x.element_size(), count_stats,
                           partial.data_ptr(), blocks, _tickets_for(x, stream).data_ptr(),
                           moments.data_ptr(), stream)
    _build.check(err, what)
    tracing.count('launches.batch_norm_train_stats')
    return moments


def _stats_fake(x, samples, count_stats):
    if _build.on_meta(x):
        _check_act('batch_norm_train_stats', x)
    return x.new_empty((2, x.shape[1]), dtype=torch.float32)


def _fwd_cpu(x, moments, weight, bias, running_mean, running_var, count, momentum, eps, relu,
             out_dtype):
    mean, var = batch_stats_reference(moments, count)
    if running_mean is not None:
        running_update_reference(running_mean, running_var, mean, var, momentum)
    return batch_norm_reference(x, mean, var, weight, bias, eps, relu, out_dtype), mean, var


def _check_fwd(x, moments, weight, bias, running_mean, running_var, out_dtype):
    what = 'batch_norm_train_fwd'
    _check_act(what, x)
    _check_vec(what, x, moments, weight, bias)
    if (running_mean is None) != (running_var is None):
        raise ValueError(f'{what}: give both running buffers or neither')
    if running_mean is not None:
        _check_vec(what, x, running_mean, running_var)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'{what} kernel: out_dtype {out_dtype}')


def _fwd_cuda(x, moments, weight, bias, running_mean, running_var, count, momentum, eps,
              relu, out_dtype):
    _check_fwd(x, moments, weight, bias, running_mean, running_var, out_dtype)
    B, C, H, W = x.shape
    y = torch.empty_like(x, dtype=out_dtype, memory_format=torch.channels_last)
    mean, var = _vec(x, C), _vec(x, C)
    moved = running_mean is not None
    err = _build.library().hpe_bn_apply(
        x.data_ptr(), x.element_size(), y.data_ptr(), y.element_size(), B * H * W, C,
        moments.data_ptr(), count, weight.data_ptr(), bias.data_ptr(), eps, int(relu),
        mean.data_ptr(), var.data_ptr(), running_mean.data_ptr() if moved else None,
        running_var.data_ptr() if moved else None, momentum, 1.0 - momentum,
        _build.num_sms(x), _build.stream_for(x))
    _build.check(err, 'batch_norm_train_fwd')
    if moved:
        # the kernel wrote them: what reads their version (a cached fold)
        # sees the change
        for t in (running_mean, running_var):
            torch.autograd.graph.increment_version(t)
    tracing.count('launches.batch_norm_train_fwd')
    return y, mean, var


def _fwd_fake(x, moments, weight, bias, running_mean, running_var, count, momentum, eps, relu,
              out_dtype):
    if _build.on_meta(x):
        _check_fwd(x, moments, weight, bias, running_mean, running_var, out_dtype)
    C = x.shape[1]
    return (torch.empty_like(x, dtype=out_dtype), x.new_empty(C, dtype=torch.float32),
            x.new_empty(C, dtype=torch.float32))


def _check_bwd(what, g, x, moments, weight, bias, *more):
    _check_act(what, x, g)
    _check_vec(what, x, moments, weight, bias, *more)


def _bwd_reduce_cpu(g, x, moments, weight, bias, count, eps, relu):
    return batch_norm_bwd_reduce_reference(g, x, moments, weight, bias, count, eps, relu)


def _bwd_reduce_cuda(g, x, moments, weight, bias, count, eps, relu):
    what = 'batch_norm_train_bwd_reduce'
    _check_bwd(what, g, x, moments, weight, bias)
    B, C, H, W = x.shape
    rows = B * H * W
    lib, stream = _build.library(), _build.stream_for(x)
    blocks, partial = _partial(lib, x, rows)
    sums, dweight, dbias, cot = _vec(x, 2, C), _vec(x, C), _vec(x, C), _vec(x, 2, C)
    err = lib.hpe_bn_bwd_reduce(
        g.data_ptr(), g.element_size(), x.data_ptr(), x.element_size(), rows, C,
        moments.data_ptr(), count, weight.data_ptr(), bias.data_ptr(), eps, int(relu),
        partial.data_ptr(), blocks, _tickets_for(x, stream).data_ptr(), sums.data_ptr(),
        dweight.data_ptr(), dbias.data_ptr(), cot.data_ptr(), stream)
    _build.check(err, what)
    tracing.count('launches.batch_norm_train_bwd_reduce')
    return dweight, dbias, cot


def _bwd_reduce_fake(g, x, moments, weight, bias, count, eps, relu):
    if _build.on_meta(x, g):
        _check_bwd('batch_norm_train_bwd_reduce', g, x, moments, weight, bias)
    C = x.shape[1]
    return (x.new_empty(C, dtype=torch.float32), x.new_empty(C, dtype=torch.float32),
            x.new_empty((2, C), dtype=torch.float32))


def _bwd_cpu(g, x, moments, weight, bias, cot, samples, count_stats, count, eps, relu):
    return batch_norm_bwd_reference(g, x, moments, weight, bias, cot, samples, count_stats,
                                    count, eps, relu)


def _bwd_cuda(g, x, moments, weight, bias, cot, samples, count_stats, count, eps, relu):
    what = 'batch_norm_train_bwd'
    _check_bwd(what, g, x, moments, weight, bias, cot)
    B, C, H, W = x.shape
    stat_rows = _samples(what, x, samples) * H * W
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    err = _build.library().hpe_bn_bwd_dx(
        g.data_ptr(), g.element_size(), x.data_ptr(), x.element_size(), dx.data_ptr(),
        B * H * W, stat_rows, C, moments.data_ptr(), count, weight.data_ptr(),
        bias.data_ptr(), eps, int(relu), cot.data_ptr(), count_stats, _build.num_sms(x),
        _build.stream_for(x))
    _build.check(err, what)
    tracing.count('launches.batch_norm_train_bwd')
    return dx


def _bwd_fake(g, x, moments, weight, bias, cot, samples, count_stats, count, eps, relu):
    if _build.on_meta(x, g):
        _check_bwd('batch_norm_train_bwd', g, x, moments, weight, bias, cot)
    return torch.empty_like(x)


for _name, _cpu, _cuda, _fake in (
        ('batch_norm_train_stats', _stats_cpu, _stats_cuda, _stats_fake),
        ('batch_norm_train_fwd', _fwd_cpu, _fwd_cuda, _fwd_fake),
        ('batch_norm_train_bwd_reduce', _bwd_reduce_cpu, _bwd_reduce_cuda, _bwd_reduce_fake),
        ('batch_norm_train_bwd', _bwd_cpu, _bwd_cuda, _bwd_fake)):
    _LIB.impl(_name, _cpu, 'CPU')
    _LIB.impl(_name, _cuda, 'CUDA')
    torch.library.register_fake(f'hpe::{_name}', _fake, lib=_LIB)


def batch_norm_train_stats(x: torch.Tensor, samples: int, count_stats: float) -> torch.Tensor:
    """The moments [2, C] f32, (sum x, sum x^2) over the first `samples`
    samples of x [B, C, H, W] (bf16 or f32), each / count_stats (the op
    `hpe::batch_norm_train_stats`).

    A CPU tensor takes the plain version; a CUDA tensor in channels-last
    memory launches the kernel (counted in tracing's
    `launches.batch_norm_train_stats`) or raises."""
    return torch.ops.hpe.batch_norm_train_stats(x, samples, count_stats)


def batch_norm_train_fwd(x, moments, weight, bias, running_mean, running_var, count: float,
                         momentum: float, eps: float, relu: bool, out_dtype):
    """(y in out_dtype, mean, var) of the moments / count: y = relu?((x -
    mean) * weight * rsqrt(var + eps) + bias); the running buffers (both or
    None) move to momentum * running + (1 - momentum) * batch in place (the
    op `hpe::batch_norm_train_fwd`; CPU: the plain version, CUDA: the
    kernel, counted in `launches.batch_norm_train_fwd`, or a raise)."""
    return torch.ops.hpe.batch_norm_train_fwd(x, moments, weight, bias, running_mean,
                                              running_var, count, momentum, eps, relu,
                                              out_dtype)


def batch_norm_train_bwd_reduce(g, x, moments, weight, bias, count: float, eps: float,
                                relu: bool):
    """(dweight, dbias, the moments' cotangent [2, C]) of the forward's
    output gradient g (the op `hpe::batch_norm_train_bwd_reduce`; CPU: the
    plain version, CUDA: the kernel, counted in
    `launches.batch_norm_train_bwd_reduce`, or a raise)."""
    return torch.ops.hpe.batch_norm_train_bwd_reduce(g, x, moments, weight, bias, count, eps,
                                                     relu)


def batch_norm_train_bwd(g, x, moments, weight, bias, cot, samples: int, count_stats: float,
                         count: float, eps: float, relu: bool) -> torch.Tensor:
    """dx in x's dtype, given the moments' cotangent `cot` (reduced over
    the data group where the statistics were) (the op
    `hpe::batch_norm_train_bwd`; CPU: the plain version, CUDA: the kernel,
    counted in `launches.batch_norm_train_bwd`, or a raise)."""
    return torch.ops.hpe.batch_norm_train_bwd(g, x, moments, weight, bias, cot, samples,
                                              count_stats, count, eps, relu)


class StatRows(NamedTuple):
    """The rows of the train-mode statistics: the first `samples` samples
    of the local batch, whose sums are divided by `count_stats`; `sync`,
    when set, reduces a [2, C] tensor over the data group (the moments in
    the forward, their cotangent in the backward: the transpose of a sum or
    of a mean over ranks is itself); the normalisation divides the reduced
    moments by `count`."""
    samples: int
    count_stats: float
    count: float
    sync: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class _TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, rows, running, momentum, eps, relu, out_dtype):
        moments = batch_norm_train_stats(x, rows.samples, rows.count_stats)
        if rows.sync is not None:
            moments = rows.sync(moments)
        y, mean, var = batch_norm_train_fwd(x, moments, weight, bias, *running, rows.count,
                                            momentum, eps, relu, out_dtype)
        ctx.save_for_backward(x, moments, weight, bias)
        ctx.rows, ctx.eps, ctx.relu = rows, eps, relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        x, moments, weight, bias = ctx.saved_tensors
        rows = ctx.rows
        if x.is_cuda:
            g = g.contiguous(memory_format=torch.channels_last)
        dweight, dbias, cot = batch_norm_train_bwd_reduce(g, x, moments, weight, bias,
                                                          rows.count, ctx.eps, ctx.relu)
        if rows.sync is not None:
            cot = rows.sync(cot)
        dx = batch_norm_train_bwd(g, x, moments, weight, bias, cot, rows.samples,
                                  rows.count_stats, rows.count, ctx.eps, ctx.relu)
        return dx, dweight, dbias, None, None, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     rows: StatRows, running=None, momentum: float = 0.9, eps: float = 1e-5,
                     relu: bool = False, out_dtype=None):
    """Differentiable train-mode BatchNorm of x [B, C, H, W] over `rows`:
    -> (y, mean, var), y = relu?(normalised x) in out_dtype (x's f32 or
    wider compute dtype when None); `running` = (running_mean,
    running_var) to move in place, or None. Two launches forward
    (statistics, apply) and two back (reduction, dx) on the card; the plain
    versions on the CPU."""
    if out_dtype is None:
        out_dtype = torch.promote_types(torch.float32, x.dtype)
    return _TrainBatchNorm.apply(x, weight, bias, rows, tuple(running or (None, None)),
                                 momentum, eps, relu, out_dtype)
