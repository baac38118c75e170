"""Visibility-weighted per-stack heatmap MSE.

Port of `hourglass_pose_estimation_tpu/loss/mse.py::heatmap_mse_loss`:
for each stack s and joint j,

    l_{s,j} = 0.5 * mean_{b, pixels} ( w_{b,j} * (pred - gt) )^2

(the weight enters squared), and L = sum_s mean_j l_{s,j}.
"""

from __future__ import annotations

import torch


def heatmap_mse_loss(outputs: torch.Tensor, target: torch.Tensor,
                     target_weight=None, use_target_weight: bool = True):
    """outputs [S, B, H, W, J], target [B, H, W, J], target_weight [B, J]
    -> scalar loss in at least f32."""
    if use_target_weight and target_weight is None:
        raise ValueError('use_target_weight=True requires target_weight '
                         '(pass use_target_weight=False for the '
                         'unweighted loss)')
    dt = torch.promote_types(torch.float32, outputs.dtype)
    diff = outputs.to(dt) - target.to(dt)[None]
    if use_target_weight:
        diff = diff * target_weight.to(dt)[None, :, None, None, :]
    per_sj = 0.5 * (diff * diff).mean(dim=(1, 2, 3))         # [S, J]
    return per_sj.mean(dim=1).sum()
