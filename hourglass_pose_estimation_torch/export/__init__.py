"""The served function (frames -> heatmaps/keypoints) and its export.

Port of `hourglass_pose_estimation_tpu/export/__init__.py`:
`fold_batchnorm`, `make_inference_fn`, and `export_stablehlo` /
`load_stablehlo` as `export_program` / `load_program`, which save and load
a `torch.export` program (.pt2). The served function, `InferenceModule`,
runs uint8 frames -> /255 -> half-pixel bilinear resize -> mean/std
normalize -> the model's last-stack heatmaps -> (optionally) the
quarter-offset or DARK decode and the inverse affine to network-input
pixels, on one device. Everything that does not depend on the frames (BN
folding, the weight cast, the fused bottlenecks' folds) is done once, when
it is built. The program keeps the Hopper kernels: each is a
`torch.library` op (`ops/hopper/`), so the graph holds one `hpe::` node a
launch, which runs the kernel on the card and the plain version on the
CPU; it is no AOTInductor package (that would compile the plain ops).

`export_savedmodel` has no counterpart: a TF SavedModel needs TensorFlow,
and ONNX, the other portable format, needs `onnx`; neither is installed
here or on the card's machine.
"""

from __future__ import annotations

import copy
import os
from collections.abc import Mapping
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.models.modules import Bottleneck, Conv
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.ops.decode import decode_dark, decode_quarter_offset
from hourglass_pose_estimation_torch.ops.resize import resize_bilinear_halfpix
from hourglass_pose_estimation_torch.weights import load_jax_variables


def fold_batchnorm(model: torch.nn.Module, eps: float = 1e-5) -> torch.nn.Module:
    """Fold every BatchNorm's running statistics into its affine, in
    place: weight' = weight/sqrt(var+eps), bias' = bias - mean*weight',
    mean 0, var 1-eps (so rsqrt(var+eps) == 1). The eval forward is
    unchanged, and each BN becomes one multiply-add. Returns the model."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                k = m.weight / torch.sqrt(m.running_var + eps)
                m.bias.copy_(m.bias - m.running_mean * k)
                m.weight.copy_(k)
                m.running_mean.zero_()
                m.running_var.fill_(1.0 - eps)
    return model


class InferenceModule(nn.Module):
    """The served function as a module: (frames) -> last-stack heatmaps,
    or (keypoints, maxvals), on one device.

    Built once: the model is copied to `device` (channels-last), given
    `variables_or_state` (a JAX `{'params', 'batch_stats'}` tree, a port
    `state_dict`, or None for the model's own weights), BatchNorm-folded
    when `fold_bn`, its conv weights cast to `weights_dtype` when set, put
    in eval mode, and each fusing bottleneck's fold frozen
    (`Bottleneck.freeze_fold`). The caller's model is left as it is.
    The forward takes a tensor on `device`: raw uint8 BGR frames [B, H, W,
    3] of any size when `preprocess=(mean, std)` is set (/255 -> resize to
    input_res^2 -> normalize run inside), else normalized NHWC images.
    decode=None returns last-stack heatmaps [B, H/4, W/4, J]; 'quarter'
    (the decode kernel on the card) or 'dark' returns (keypoints [B, J, 2]
    in network-input pixels, maxvals [B, J]), both 0-based."""

    def __init__(self, model: nn.Module, variables_or_state=None,
                 decode: Optional[str] = None, fold_bn: bool = False,
                 weights_dtype=None, preprocess: Optional[Tuple] = None,
                 input_res: Optional[int] = None, device='cuda'):
        super().__init__()
        if decode not in (None, 'quarter', 'dark'):
            raise ValueError(f"decode must be None, 'quarter' or 'dark', got {decode!r}")
        if preprocess is not None and input_res is None:
            raise ValueError('preprocess requires input_res')
        dev = resolve_device(device)
        model = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
        if isinstance(variables_or_state, Mapping) and 'params' in variables_or_state:
            load_jax_variables(model, variables_or_state)
        elif variables_or_state is not None:
            model.load_state_dict(variables_or_state, strict=True)
        if fold_bn:
            fold_batchnorm(model)
        if weights_dtype is not None:
            for m in model.modules():
                if isinstance(m, Conv):
                    m.weight.data = m.weight.data.to(weights_dtype)
        model.eval()
        for m in model.modules():
            if isinstance(m, Bottleneck) and m.fusable():
                m.freeze_fold()
        self.model, self.decode, self.input_res = model, decode, input_res
        self.device = dev
        self.preprocess = preprocess is not None
        if self.preprocess:
            f32 = dict(dtype=torch.float32, device=dev)
            self.register_buffer('mean', torch.as_tensor(preprocess[0], **f32))
            self.register_buffer('std', torch.as_tensor(preprocess[1], **f32))

    def forward(self, images: torch.Tensor):
        x = images.to(torch.float32)
        if self.preprocess:
            x = resize_bilinear_halfpix(x / 255.0, (self.input_res, self.input_res))
            x = (x - self.mean) / self.std
        hms = self.model(x)[-1]
        if self.decode is None:
            return hms
        B, R = hms.shape[0], x.shape[1]
        centers = torch.full((B, 2), R / 2.0, dtype=torch.float32, device=hms.device)
        scales = torch.full((B, 2), R / 200.0, dtype=torch.float32, device=hms.device)
        decoder = decode_dark if self.decode == 'dark' else decode_quarter_offset
        return decoder(hms, centers, scales, zero_based=True)


def make_inference_fn(model: nn.Module, variables_or_state=None,
                      decode: Optional[str] = None, fold_bn: bool = False,
                      weights_dtype=None, preprocess: Optional[Tuple] = None,
                      input_res: Optional[int] = None, device='cuda'):
    """Inference callable over a batch of NHWC frames: an `InferenceModule`
    (see it for the arguments) called under `torch.inference_mode` on
    frames given as a tensor or a numpy array, moved to `device` first.
    Results stay on `device`."""
    module = InferenceModule(model, variables_or_state, decode=decode, fold_bn=fold_bn,
                             weights_dtype=weights_dtype, preprocess=preprocess,
                             input_res=input_res, device=device)
    return serving_callable(module, module.device)


def serving_callable(module, device: torch.device):
    """`module` (an InferenceModule, or a loaded program's module) as a
    callable under `torch.inference_mode` over frames given as a tensor or
    a numpy array, moved to `device` first."""
    @torch.inference_mode()
    def fn(images):
        return module(_to_device(images, device))
    return fn


def export_program(model: nn.Module, variables_or_state, input_shape: Tuple[int, ...],
                   path: str, decode: Optional[str] = None, fold_bn: bool = False,
                   preprocess: Optional[Tuple] = None, input_res: Optional[int] = None,
                   weights_dtype=None, device='cuda') -> str:
    """Save the served function as a `torch.export` program at `path` (a
    .pt2); returns the path. The counterpart of the JAX package's
    `export_stablehlo`, with the same graph options (see
    `InferenceModule`): the program is traced on `device` at the static
    `input_shape`, uint8 frames when `preprocess` is set, else f32 images.
    Its graph keeps each Hopper kernel as an `hpe::` node and each frozen
    fold as a constant; `load_program` reads it back."""
    module = InferenceModule(model, variables_or_state, decode=decode, fold_bn=fold_bn,
                             weights_dtype=weights_dtype, preprocess=preprocess,
                             input_res=input_res, device=device)
    dtype = torch.uint8 if preprocess is not None else torch.float32
    example = torch.zeros(tuple(input_shape), dtype=dtype, device=module.device)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    _drop_noop_casts(program)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    torch.export.save(program, path)
    return path


def _drop_noop_casts(program: torch.export.ExportedProgram) -> None:
    """Drop from the traced graph what costs a dispatch at every call and
    computes nothing: the metadata assertion that export records before
    each `.to`, and each cast to the dtype its input already has (every
    BatchNorm casts its f32 parameters to f32). A third of the nodes of an
    f32 hourglass; the program reads and runs the faster."""
    graph = program.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default and not node.users:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype
              and node.args[0].meta['val'].dtype == node.meta['val'].dtype):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def read_program(path: str, device='cuda') -> torch.export.ExportedProgram:
    """The program `export_program` saved at `path`, moved to `device`.
    Importing this package registers the `hpe::` ops the program calls,
    which `torch.export.load` needs."""
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(torch.export.load(path), resolve_device(device))


def load_program(path: str, device='cuda'):
    """Load a program `export_program` saved: a callable under
    `torch.inference_mode` over frames (a tensor or a numpy array, moved to
    `device` first) with results on `device`. The counterpart of the JAX
    package's `load_stablehlo`."""
    dev = resolve_device(device)
    return serving_callable(read_program(path, dev).module(), dev)


def _to_device(frames, dev: torch.device) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames.to(dev)
    return torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
