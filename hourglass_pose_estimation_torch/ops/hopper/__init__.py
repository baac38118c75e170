"""Hand-written Hopper kernels (CUDA C++, `csrc/`), each beside its plain
PyTorch version. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises. `upsample2x_add`,
`maxpool2x2`, `fused_bottleneck` and `batch_norm_train` are
differentiable (autograd Functions over the forward and backward
wrappers); `fused_bottleneck` runs one of two kernels,
`fused_bottleneck_image` or `fused_bottleneck_chunked`
(`bottleneck.DEFAULT_IMPL` unless the call names one).

Every kernel is a `torch.library` op in the `hpe` namespace (the launch
functions of KERNEL_WRAPPERS, by the same names), registered when this
package is imported: a CPU kernel (the plain version), a CUDA kernel (the
launch) and a fake for shapes. So eager calls and `torch.export` take the
same route, and an exported program keeps one `hpe::` node a launch; a
process loads such a program only after importing this package."""

from hourglass_pose_estimation_torch.ops.hopper.batchnorm import (
    StatRows, batch_moments_reference, batch_norm_reference, batch_norm_train,
    batch_norm_train_bwd, batch_norm_train_bwd_reduce, batch_norm_train_fwd,
    batch_norm_train_stats, batch_stats_reference, running_update_reference)
from hourglass_pose_estimation_torch.ops.hopper.bottleneck import (
    BottleneckParams, bottleneck_backward_reference, bottleneck_reference,
    fold_bn, fused_bottleneck, fused_bottleneck_chunked, fused_bottleneck_image,
    params_from_variables)
from hourglass_pose_estimation_torch.ops.hopper.decode import (
    decode_peaks, decode_peaks_reference)
from hourglass_pose_estimation_torch.ops.hopper.pool import (
    maxpool2x2, maxpool2x2_bwd, maxpool2x2_bwd_first,
    maxpool2x2_bwd_first_reference, maxpool2x2_bwd_reference, maxpool2x2_fwd,
    maxpool2x2_reference)
from hourglass_pose_estimation_torch.ops.hopper.render import (
    render_gaussian, render_gaussian_reference)
from hourglass_pose_estimation_torch.ops.hopper.upsample import (
    upsample2x_add, upsample2x_add_bwd, upsample2x_add_bwd_reference,
    upsample2x_add_reference, upsample2x_nearest)

from hourglass_pose_estimation_torch.utils import tracing

# every kernel's wrapper; each counts its launches in the tracing counter
# `launches.<wrapper name>`
KERNEL_WRAPPERS = (fused_bottleneck_image, fused_bottleneck_chunked,
                   upsample2x_add, decode_peaks,
                   upsample2x_add_bwd, maxpool2x2_fwd, maxpool2x2_bwd,
                   maxpool2x2_bwd_first, render_gaussian,
                   batch_norm_train_stats, batch_norm_train_fwd,
                   batch_norm_train_bwd_reduce, batch_norm_train_bwd)


def launch_counts() -> dict:
    """{wrapper name: its launches since the last `tracing.reset()`}, every
    wrapper of KERNEL_WRAPPERS."""
    counts = tracing.counters()
    return {w.__name__: counts.get(f'launches.{w.__name__}', 0) for w in KERNEL_WRAPPERS}
