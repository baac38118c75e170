"""Heatmap-space PCK, on the device.

Port of `hourglass_pose_estimation_tpu/utils/evaluation.py` (`get_preds`,
`calc_dists`, `dist_acc`, `accuracy`, `pck_counts`, `combine_pck_counts`),
with the reference's quirks: `get_preds` gives MATLAB-flavoured 1-based
coordinates x = (idx-1) % W + 1, y = floor((idx-1)/W) + 1 (so a peak at
flat index 0 lands on (W, 0)) and zeroes predictions whose max is <= 0;
a joint counts only where its ground-truth coordinates are > 1; the
normaliser is heatmap width / 10. Heatmaps are [B, H, W, J].
"""

from __future__ import annotations

import torch


def get_preds(heatmaps: torch.Tensor):
    """[B, H, W, J] -> (preds [B, J, 2] f32 1-based (x, y), zeroed where
    the max is <= 0; maxvals [B, J])."""
    B, H, W, J = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, J)
    maxvals, idx = flat.max(dim=1)          # first maximal index, as argmax
    idx0 = idx - 1
    x = (torch.remainder(idx0, W) + 1).float()
    y = (torch.div(idx0, W, rounding_mode='floor') + 1).float()
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0).float()[..., None], maxvals


def calc_dists(preds: torch.Tensor, target: torch.Tensor,
               normalize: torch.Tensor) -> torch.Tensor:
    """[B, J] normalised distances; -1 where the ground truth is degenerate."""
    valid = (target[..., 0] > 1.0) & (target[..., 1] > 1.0)
    d = torch.linalg.vector_norm(preds - target, dim=-1) / normalize[:, None]
    return torch.where(valid, d, torch.full_like(d, -1.0))


def dist_acc(dists: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
    """Fraction of valid distances below thr; -1 if none is valid."""
    valid = dists != -1.0
    n = valid.sum()
    hit = ((dists < thr) & valid).sum()
    return torch.where(n > 0, hit / n.clamp_min(1), torch.tensor(-1.0, device=dists.device))


def pck_counts(output: torch.Tensor, target: torch.Tensor, idxs=None,
               thr: float = 0.5):
    """Per-joint PCK numerators and denominators (hit [J'], n [J'])."""
    B, H, W, J = output.shape
    preds, _ = get_preds(output)
    gts, _ = get_preds(target)
    norm = torch.full((B,), W / 10.0, dtype=torch.float32, device=output.device)
    dists = calc_dists(preds, gts, norm)
    if idxs is not None:
        dists = dists[:, :len(idxs)]
    valid = dists != -1.0
    return ((dists < thr) & valid).sum(dim=0), valid.sum(dim=0)


def combine_pck_counts(hit: torch.Tensor, n: torch.Tensor):
    """(hit [J], n [J]) -> (avg_acc, per_joint_acc [J], scored joint count)."""
    per_joint = torch.where(n > 0, hit / n.clamp_min(1),
                            torch.full(n.shape, -1.0, device=n.device))
    scored = per_joint >= 0
    cnt = scored.sum()
    total = torch.where(scored, per_joint, torch.zeros_like(per_joint)).sum()
    avg = torch.where(cnt > 0, total / cnt.clamp_min(1),
                      torch.zeros((), device=n.device))
    return avg, per_joint, cnt


def accuracy(output: torch.Tensor, target: torch.Tensor, idxs=None,
             thr: float = 0.5):
    """Heatmap-space PCK of [B, H, W, J] maps -> (avg_acc, per_joint_acc
    [J], valid joint count). `idxs` is used for its LENGTH only: score the
    first len(idxs) joints, as the reference does."""
    return combine_pck_counts(*pck_counts(output, target, idxs=idxs, thr=thr))
