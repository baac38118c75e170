"""Hand-written Hopper kernels (CUDA C++, `csrc/`), each beside its plain
PyTorch version. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises. `upsample2x_add`,
`maxpool2x2` and `fused_bottleneck` are differentiable (autograd
Functions over the forward and backward wrappers)."""

from hourglass_pose_estimation_torch.ops.hopper.bottleneck import (
    BottleneckParams, bottleneck_backward_reference, bottleneck_reference,
    fold_bn, fused_bottleneck, params_from_variables)
from hourglass_pose_estimation_torch.ops.hopper.decode import (
    decode_peaks, decode_peaks_reference)
from hourglass_pose_estimation_torch.ops.hopper.pool import (
    maxpool2x2, maxpool2x2_bwd, maxpool2x2_bwd_reference, maxpool2x2_fwd,
    maxpool2x2_reference)
from hourglass_pose_estimation_torch.ops.hopper.render import (
    render_gaussian, render_gaussian_reference)
from hourglass_pose_estimation_torch.ops.hopper.upsample import (
    upsample2x_add, upsample2x_add_bwd, upsample2x_add_bwd_reference,
    upsample2x_add_reference, upsample2x_nearest)

# every kernel's wrapper; each counts its launches in `.launches`
KERNEL_WRAPPERS = (fused_bottleneck, upsample2x_add, decode_peaks,
                   upsample2x_add_bwd, maxpool2x2_fwd, maxpool2x2_bwd,
                   render_gaussian)
