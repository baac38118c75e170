"""Inference function of the serving path: frames -> heatmaps/keypoints.

Port of `hourglass_pose_estimation_tpu/export/__init__.py::
fold_batchnorm` and `make_inference_fn`. The returned callable runs
uint8 frames -> /255 -> half-pixel bilinear resize -> mean/std normalize
-> the model's last-stack heatmaps -> (optionally) the quarter-offset or
DARK decode and the inverse affine to network-input pixels, on one device.
Everything that does not depend on the frames (BN folding, the weight
cast) is done once, when it is built; the fused kernels' parameters are
folded at the first call and kept while the weights stay as they are.
`export_stablehlo` / `export_savedmodel` become a `torch.export` slice.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Optional, Tuple

import numpy as np
import torch

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.models.modules import Conv
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


def make_inference_fn(model: torch.nn.Module, variables_or_state=None,
                      decode: Optional[str] = None, fold_bn: bool = False,
                      weights_dtype=None, preprocess: Optional[Tuple] = None,
                      input_res: Optional[int] = None, device='cuda'):
    """Inference callable over a batch of NHWC frames.

    variables_or_state: a JAX `{'params', 'batch_stats'}` tree, a port
    `state_dict`, or None for the model's own weights. The model is
    copied; the caller's model is left as it is.
    decode=None returns last-stack heatmaps [B, H/4, W/4, J];
    decode='quarter' (the decode kernel on the card) or 'dark' returns
    (keypoints [B, J, 2] in network-input pixels, maxvals [B, J]), both
    0-based. fold_bn folds BatchNorm statistics;
    weights_dtype (e.g. torch.bfloat16) casts the conv weights.
    preprocess=(mean, std) with input_res: the callable takes RAW uint8
    BGR frames [B, H, W, 3] of any size and runs /255 -> resize to
    input_res^2 -> normalize itself. Results stay on `device`."""
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

    if preprocess is not None:
        mean = torch.as_tensor(preprocess[0], dtype=torch.float32, device=dev)
        std = torch.as_tensor(preprocess[1], dtype=torch.float32, device=dev)

        def prepare(frames):
            x = _to_device(frames, dev).to(torch.float32) / 255.0
            x = resize_bilinear_halfpix(x, (input_res, input_res))
            return (x - mean) / std
    else:
        prepare = lambda images: _to_device(images, dev).to(torch.float32)

    @torch.inference_mode()
    def fn(images):
        x = prepare(images)
        hms = model(x)[-1]
        if decode is None:
            return hms
        B, R = hms.shape[0], x.shape[1]
        centers = torch.full((B, 2), R / 2.0, dtype=torch.float32, device=dev)
        scales = torch.full((B, 2), R / 200.0, dtype=torch.float32, device=dev)
        decoder = decode_dark if decode == 'dark' else decode_quarter_offset
        return decoder(hms, centers, scales, zero_based=True)

    return fn


def _to_device(frames, dev: torch.device) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames.to(dev)
    return torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
