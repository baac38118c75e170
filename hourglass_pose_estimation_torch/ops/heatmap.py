"""Gaussian heatmap target rendering on the device.

Port of `hourglass_pose_estimation_tpu/ops/heatmap.py`: `render_preamble`
(the reference's int()-truncating peak quantisation and window-miss
weight zeroing) is plain tensor code shared by the render kernel and its
plain version (`ops/hopper/render.py`); `render_gaussian_targets` runs
the preamble and then the render, which launches the kernel for CUDA
tensors.
"""

from __future__ import annotations

import torch

from hourglass_pose_estimation_torch.ops.hopper.render import render_gaussian


def render_preamble(joints, joints_vis, heatmap_size, image_size, sigma):
    """-> (mu [B, J, 2] int32 peak coordinates, weight [B, J] f32)."""
    joints = torch.as_tensor(joints, dtype=torch.float32)
    dev = joints.device
    vis = torch.as_tensor(joints_vis, dtype=torch.float32, device=dev)
    Wh, Hh = int(heatmap_size[0]), int(heatmap_size[1])
    Wi, Hi = int(image_size[0]), int(image_size[1])
    stride = torch.tensor([Wi / Wh, Hi / Hh], dtype=torch.float32, device=dev)
    tmp = int(3 * sigma)
    mu = torch.trunc(joints / stride + 0.5).to(torch.int32)
    ul, br = mu - tmp, mu + tmp + 1
    size = torch.tensor([Wh, Hh], dtype=torch.int32, device=dev)
    off_map = (ul >= size).any(dim=-1) | (br < 0).any(dim=-1)
    weight = torch.where(off_map, torch.zeros_like(vis), vis)
    return mu.contiguous(), weight.contiguous()


def render_gaussian_targets(joints, joints_vis, *, heatmap_size, image_size,
                            sigma):
    """joints [B, J, 2] (x, y) input-image pixels, joints_vis [B, J] ->
    (target [B, Hh, Wh, J] f32, target_weight [B, J] f32)."""
    mu, weight = render_preamble(joints, joints_vis, heatmap_size,
                                 image_size, sigma)
    return render_gaussian(mu, weight, heatmap_size, sigma), weight
