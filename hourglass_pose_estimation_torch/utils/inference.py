"""Reference-shaped wrappers over the batched decoders (the port of
`hourglass_pose_estimation_tpu/utils/inference.py`).

The reference exposes `get_final_preds_v1` / `get_final_preds_v2` /
`gaussian_blur` as host-side per-sample helpers (its
utils/inference.py:9-87). These names map onto the batched decoders of
`ops/decode.py`, on the CPU, and return numpy arrays; use those decoders
directly for batched work on the card. The layout is explicit and
defaults to the reference's NCHW ([B, J, H, W]); pass layout='NHWC' for
[B, H, W, J] maps.
"""

from __future__ import annotations

import numpy as np
import torch

from hourglass_pose_estimation_torch.ops.decode import (
    decode_dark, decode_quarter_offset, gaussian_blur as _gaussian_blur)


def _to_nhwc(hms, layout: str) -> torch.Tensor:
    if layout not in ('NCHW', 'NHWC'):
        raise ValueError(f"layout must be 'NCHW' or 'NHWC', got {layout!r}")
    hms = np.asarray(hms)
    if layout == 'NCHW':
        hms = hms.transpose(0, 2, 3, 1)
    return torch.from_numpy(np.ascontiguousarray(hms))


def _broadcast_cs(center, scale, B):
    centers = np.broadcast_to(np.asarray(center, np.float32), (B, 2))
    scales = np.asarray(scale, np.float32)
    if scales.ndim == 0:
        scales = np.broadcast_to(scales, (B,))
    elif scales.ndim == 1 and scales.shape[0] == 2:
        # a shape-(2,) vector is read as ONE (sx, sy) pair broadcast over
        # the batch (the reference's per-call shape). With B == 2 that is
        # ambiguous against two per-sample scalar scales: refuse to guess;
        # per-sample scales must be [B, 1] or [B, 2]
        if B == 2 and float(scales[0]) != float(scales[1]):
            raise ValueError('ambiguous scale of shape (2,) with batch 2: pass '
                             '[B, 2] per-sample scales or a scalar')
        scales = np.broadcast_to(scales, (B, 2))
    return np.array(centers), np.array(scales)


def _size(output_size):
    return tuple(int(v) for v in output_size) if output_size is not None else None


def get_final_preds_v1(hms, center, scale, output_size=None,
                       layout: str = 'NCHW') -> np.ndarray:
    """Argmax + quarter-offset decode (the reference's 1-based parity mode)
    -> source-image coordinates [B, J, 2]. `output_size` (w, h), when
    given, is the size the inverse affine maps from (the reference's
    transform_preds output_size); the default is the heatmap size."""
    nhwc = _to_nhwc(hms, layout)
    centers, scales = _broadcast_cs(center, scale, nhwc.shape[0])
    preds, _ = decode_quarter_offset(nhwc, centers, scales, affine_size=_size(output_size))
    return preds.numpy()


def get_final_preds_v2(hms, center, scale, output_size=None,
                       layout: str = 'NCHW') -> np.ndarray:
    """DARK decode -> source-image coordinates [B, J, 2]; `output_size` as
    in `get_final_preds_v1`. Like the JAX package, every joint gets the
    Taylor step (the reference's loop reaches joints 0 and 1 only)."""
    nhwc = _to_nhwc(hms, layout)
    centers, scales = _broadcast_cs(center, scale, nhwc.shape[0])
    preds, _ = decode_dark(nhwc, centers, scales, affine_size=_size(output_size))
    return preds.numpy()


def gaussian_blur(hms, kernel: int = 11, layout: str = 'NCHW') -> np.ndarray:
    """Batched blur with the reference's zero padding and max rescale, in
    the layout it was given."""
    out = _gaussian_blur(_to_nhwc(hms, layout), kernel).numpy()
    return out.transpose(0, 3, 1, 2) if layout == 'NCHW' else out
