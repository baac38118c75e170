"""Hand-written Hopper kernels (CUDA C++, `csrc/`), each beside its plain
PyTorch version. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises."""

from hourglass_pose_estimation_torch.ops.hopper.bottleneck import (
    BottleneckParams, bottleneck_reference, fold_bn, fused_bottleneck,
    params_from_variables)
from hourglass_pose_estimation_torch.ops.hopper.decode import (
    decode_peaks, decode_peaks_reference)
from hourglass_pose_estimation_torch.ops.hopper.upsample import (
    upsample2x_add, upsample2x_add_reference, upsample2x_nearest)

KERNEL_WRAPPERS = (fused_bottleneck, upsample2x_add, decode_peaks)
