"""Batched heatmap decoding on device.

Port of the serving decoder of `hourglass_pose_estimation_tpu/ops/
decode.py`: `get_preds_zero_based` and `decode_quarter_offset(
zero_based=True)`. The argmax and the quarter-pixel step go through
`ops/hopper/decode.py::decode_peaks` (the kernel on a CUDA tensor, its
plain version on the CPU); the inverse affine back to image pixels is
tensor math. The 1-based reference-parity decode, DARK and the NMS
decoders come with the eval slice.
"""

from __future__ import annotations

import torch

from hourglass_pose_estimation_torch.ops.hopper.decode import decode_peaks
from hourglass_pose_estimation_torch.utils.transforms import (
    batched_affine_transforms, batched_apply_affine)

_EVAL_SLICE = 'comes with the eval slice: ROADMAP Queue 1 item 11'


def get_preds_zero_based(heatmaps: torch.Tensor):
    """Clean 0-based per-joint argmax: [B, H, W, J] -> ([B, J, 2], [B, J])."""
    B, H, W, J = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, J)
    idx = torch.argmax(flat, dim=1)
    maxvals = flat.amax(dim=1)
    coords = torch.stack([(idx % W).to(torch.float32),
                          torch.div(idx, W, rounding_mode='floor').to(torch.float32)], -1)
    return coords, maxvals


def decode_quarter_offset(heatmaps: torch.Tensor, centers, scales,
                          zero_based: bool = False, affine_size=None):
    """Argmax + quarter-pixel offset decode, batched.

    heatmaps [B, H, W, J]; centers [B, 2] and scales [B] or [B, 2] of the
    person boxes; affine_size (w, h) defaults to the heatmap size.
    Returns (keypoints [B, J, 2] in source-image pixels, maxvals [B, J]).
    Only zero_based=True (the corrected 0-based convention) is ported."""
    if not zero_based:
        raise NotImplementedError('decode_quarter_offset(zero_based=False) '
                                  '(1-based get_preds) ' + _EVAL_SLICE)
    B, H, W, J = heatmaps.shape
    coords, maxvals = decode_peaks(heatmaps.to(torch.float32).contiguous())
    size = affine_size if affine_size is not None else (W, H)
    centers = torch.as_tensor(centers, dtype=torch.float32, device=heatmaps.device)
    inv = batched_affine_transforms(
        centers, scales, torch.zeros((B,), device=heatmaps.device), size, inv=True)
    return batched_apply_affine(coords, inv), maxvals


def decode_dark(*args, **kwargs):
    raise NotImplementedError('decode_dark ' + _EVAL_SLICE)


def decode_nms_peaks(*args, **kwargs):
    raise NotImplementedError('decode_nms_peaks ' + _EVAL_SLICE)


def decode_nms_topk(*args, **kwargs):
    raise NotImplementedError('decode_nms_topk ' + _EVAL_SLICE)
