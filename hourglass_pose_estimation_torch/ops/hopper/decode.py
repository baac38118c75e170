"""Batched heatmap peak decode (argmax + quarter offset): Hopper kernel +
plain version.

Port of `hourglass_pose_estimation_tpu/ops/pallas/decode.py::
decode_peaks_pallas`. The kernel is `csrc/decode.cu`; its header says
what bounds it. Like the TPU kernel it implements the corrected 0-based
convention only, i.e. it substitutes for
`decode_quarter_offset(zero_based=True)` before the inverse affine.
"""

from __future__ import annotations

import torch

from hourglass_pose_estimation_torch.ops.hopper import _build


def decode_peaks_reference(heatmaps: torch.Tensor):
    """Plain version: [B, H, W, J] -> (coords [B, J, 2] 0-based
    quarter-refined, maxvals [B, J]), first row-major argmax."""
    hm = heatmaps.to(torch.float32)
    B, H, W, J = hm.shape
    flat = hm.reshape(B, H * W, J)
    maxv = flat.amax(dim=1)
    idx = torch.argmax(flat, dim=1)               # first maximal element
    px, py = idx % W, torch.div(idx, W, rounding_mode='floor')
    padded = torch.nn.functional.pad(hm, (0, 0, 1, 1, 1, 1))   # zero edges

    def at(dy, dx):
        lin = (py + 1 + dy) * (W + 2) + (px + 1 + dx)
        return padded.reshape(B, (H + 2) * (W + 2), J).gather(
            1, lin[:, None, :]).squeeze(1)

    gx = at(0, 1) - at(0, -1)
    gy = at(1, 0) - at(-1, 0)
    ok = (px > 0) & (px < W - 1) & (py > 0) & (py < H - 1)
    zero = torch.zeros_like(gx)
    fx = px.to(torch.float32) + torch.where(ok, torch.sign(gx) * 0.25, zero)
    fy = py.to(torch.float32) + torch.where(ok, torch.sign(gy) * 0.25, zero)
    return torch.stack([fx, fy], dim=-1), maxv


def decode_peaks(heatmaps: torch.Tensor):
    """[B, H, W, J] f32 -> (coords [B, J, 2], maxvals [B, J]).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in `decode_peaks.launches`) or raises."""
    if heatmaps.device.type == 'cpu':
        return decode_peaks_reference(heatmaps)
    if (heatmaps.dtype != torch.float32 or heatmaps.dim() != 4
            or not heatmaps.is_contiguous()):
        raise ValueError('decode_peaks kernel: heatmaps must be a contiguous '
                         f'[B, H, W, J] f32 tensor, got {heatmaps.dtype} '
                         f'{tuple(heatmaps.shape)}')
    B, H, W, J = heatmaps.shape
    if not 1 <= J <= 1024:
        raise ValueError(f'decode_peaks kernel: J={J} outside [1, 1024]')
    coords = torch.empty((B, J, 2), dtype=torch.float32, device=heatmaps.device)
    maxvals = torch.empty((B, J), dtype=torch.float32, device=heatmaps.device)
    err = _build.library().hpe_decode_peaks(
        heatmaps.data_ptr(), coords.data_ptr(), maxvals.data_ptr(),
        B, H, W, J, _build.stream_for(heatmaps))
    _build.check(err, 'decode_peaks')
    decode_peaks.launches += 1
    return coords, maxvals


decode_peaks.launches = 0
