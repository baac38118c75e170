"""On-device augmentation + target rendering.

Port of `hourglass_pose_estimation_tpu/data/pipeline.py` (`PipelineSpec`,
`make_spec`, `sample_augmentations`, `augment_batch`, and `crop_batch`,
its steps 1-4 and the joints: the crops alone): given a batch of
uint8 canvases and person geometry, on the batch's device,

  1. the flip, scale and rotation draws (`sample_augmentations`, from an
     explicit `torch.Generator`; one U(0, 1) gates flip (p <= 0.5) and
     rotation (p <= 0.6); scale jitter clip(N(1, sf), 1 +- sf); rotation
     clip(N(0, rf), +-2 rf)),
  2. the crop affines in closed form, with the flip and the canvas
     pre-scale composed into one warp,
  3. the bilinear warp of the canvases to the input resolution (the gather
     warp with rotation, the separable one without),
  4. normalisation with the dataset mean/std (BGR),
  5. the joints through the same affine, and the Gaussian targets.

torch and jax.random streams differ, so `augment_batch` takes the draws
as an input; the train step draws them from a generator per step.

`prepare_host_batch` is the device tail of the host (cv2) pipeline: steps
4 and 5 on crops the host already warped.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from hourglass_pose_estimation_torch.ops.heatmap import render_gaussian_targets
from hourglass_pose_estimation_torch.ops.warp import (
    affine_warp, affine_warp_separable)
from hourglass_pose_estimation_torch.utils.transforms import (
    batched_affine_transforms, batched_apply_affine)


class PipelineSpec(NamedTuple):
    """Static configuration of the device pipeline."""
    inp_res: int
    out_res: int
    sigma: int
    scale_factor: float
    rot_factor: float
    flip_perm: Tuple[int, ...]       # joint permutation under horizontal flip
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


def make_spec(dataset, train_cfg=None) -> PipelineSpec:
    """A PipelineSpec from a PoseDataset (`train_cfg` is accepted and
    unused, as in the JAX package)."""
    return PipelineSpec(
        inp_res=dataset.inp_res, out_res=dataset.out_res, sigma=dataset.sigma,
        scale_factor=dataset.scale_factor, rot_factor=dataset.rot_factor,
        flip_perm=tuple(int(i) for i in dataset.flip_permutation()),
        mean=tuple(dataset.mean), std=tuple(dataset.std))


def sample_augmentations(gen, scales: torch.Tensor, *, scale_factor: float,
                         rot_factor: float, train: bool):
    """(scales [B, 2] after jitter, rots [B] degrees, flips [B] bool), drawn
    from `gen` (a torch.Generator on scales' device) with the reference
    distributions; without `train` the identity draws."""
    B, dev = scales.shape[0], scales.device
    if not train:
        return scales, torch.zeros((B,), device=dev), torch.zeros((B,), dtype=torch.bool, device=dev)
    prob = torch.rand((B,), generator=gen, device=dev)
    sf, rf = scale_factor, rot_factor
    s_mult = torch.clamp(torch.randn((B,), generator=gen, device=dev) * sf + 1.0,
                         1.0 - sf, 1.0 + sf)
    rots = torch.clamp(torch.randn((B,), generator=gen, device=dev) * rf,
                       -2.0 * rf, 2.0 * rf)
    rots = torch.where(prob <= 0.6, rots, torch.zeros_like(rots))
    return scales * s_mult[:, None], rots, prob <= 0.5


def to_device(batch, device) -> dict:
    """A canvas batch (numpy arrays, or tensors already staged) as tensors
    on `device` (numpy arrays are copied: they may be read-only views)."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v, order='C')).to(device)
            for k, v in batch.items()}


def normalize(imgs: torch.Tensor, spec: PipelineSpec) -> torch.Tensor:
    """BGR 0-255 images (uint8 or f32) -> f32 (x / 255 - mean) / std."""
    f32 = torch.float32
    mean = torch.tensor(spec.mean, dtype=f32, device=imgs.device)
    std = torch.tensor(spec.std, dtype=f32, device=imgs.device)
    return (imgs.to(f32) / 255.0 - mean) / std


def crop_batch(batch, draws, spec: PipelineSpec, train: bool) -> dict:
    """Canvases -> normalised inputs and their geometry, on the batch's
    device: `augment_batch` without the targets (what a forward that
    needs no loss reads).

    batch: `PoseDataset.canvas_batch` as tensors (see `to_device`):
      canvas [B, S, S, 3] uint8, canvas_scale [B], canvas_offset [B, 2],
      center [B, 2], scale [B, 2], joints [B, J, 2], vis [B, J], width [B].
    draws: (scales [B, 2], rots [B], flips [B] bool) from
      `sample_augmentations`.
    Returns image [B, R, R, 3] f32, joints_input [B, J, 2], vis [B, J]
    (flipped with the joints), and the post-augmentation center, scale
    and rotation."""
    f32 = torch.float32
    R = spec.inp_res
    canvas = batch['canvas']
    dev = canvas.device
    q = batch['canvas_scale'].to(f32)
    canvas_off = batch['canvas_offset'].to(f32)
    centers = batch['center'].to(f32)
    joints = batch['joints'].to(f32)
    vis = batch['vis'].to(f32)
    widths = batch['width'].to(f32)
    scales_a, rots, flips = draws

    # flip in source-image coordinates
    centers_f = torch.stack(
        [torch.where(flips, widths - centers[:, 0] - 1.0, centers[:, 0]),
         centers[:, 1]], dim=-1)
    perm = torch.as_tensor(spec.flip_perm, dtype=torch.int64, device=dev)
    joints_sw, vis_sw = joints[:, perm, :], vis[:, perm]
    joints_f = torch.where(
        flips[:, None, None],
        torch.stack([widths[:, None] - joints_sw[..., 0] - 1.0,
                     joints_sw[..., 1]], dim=-1),
        joints)
    vis_f = torch.where(flips[:, None], vis_sw, vis)

    # crop affine (source -> input crop), composed with flip and canvas map:
    # x_src = width-1-x_flipped when flipped; x_canvas = q * (x_src - ox)
    fwd = batched_affine_transforms(centers_f, scales_a, rots, (R, R))
    inv = batched_affine_transforms(centers_f, scales_a, rots, (R, R), inv=True)
    a, b, c = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    d, e, f = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    sgn = torch.where(flips, -1.0, 1.0)
    off = torch.where(flips, widths - 1.0, torch.zeros_like(widths))
    ox, oy = canvas_off[:, 0], canvas_off[:, 1]
    row0 = torch.stack([q * sgn * a, q * sgn * b, q * (sgn * c + off - ox)], dim=-1)
    row1 = torch.stack([q * d, q * e, q * (f - oy)], dim=-1)
    inv_canvas = torch.stack([row0, row1], dim=1)          # [B, 2, 3]

    if train and spec.rot_factor > 0:
        imgs = affine_warp(canvas, inv_canvas, (R, R))
    else:
        imgs = affine_warp_separable(canvas, inv_canvas, (R, R))

    return {'image': normalize(imgs, spec), 'joints_input': batched_apply_affine(joints_f, fwd),
            'vis': vis_f, 'center': centers_f, 'scale': scales_a, 'rotation': rots}


def augment_batch(batch, draws, spec: PipelineSpec, train: bool) -> dict:
    """Canvases -> normalised inputs, targets and weights, on the batch's
    device: `crop_batch`, then the Gaussian targets of the cropped joints.
    Returns image [B, R, R, 3] f32, target [B, h, w, J] f32,
    target_weight [B, J], joints_input [B, J, 2], and the post-augmentation
    center, scale and rotation."""
    data = crop_batch(batch, draws, spec, train)
    R = spec.inp_res
    target, tw = render_gaussian_targets(
        data['joints_input'], data.pop('vis'), heatmap_size=(spec.out_res, spec.out_res),
        image_size=(R, R), sigma=spec.sigma)
    return dict(data, target=target, target_weight=tw)


def prepare_host_batch(batch, spec: PipelineSpec) -> dict:
    """Host crops -> normalised inputs, targets and weights, on the batch's
    device: the device tail of the host pipeline (`PoseDataset.host_batch`
    did the draws and the warp).

    batch: image [B, R, R, 3] BGR 0-255 (uint8, or the same values in f32),
    joints [B, J, 2] in crop pixels, vis [B, J], as tensors.
    Returns image [B, R, R, 3] f32 normalised, target [B, h, w, J] f32 and
    target_weight [B, J] (the render kernel on the card)."""
    f32 = torch.float32
    R = spec.inp_res
    target, tw = render_gaussian_targets(
        batch['joints'].to(f32), batch['vis'].to(f32),
        heatmap_size=(spec.out_res, spec.out_res), image_size=(R, R), sigma=spec.sigma)
    return {'image': normalize(batch['image'], spec), 'target': target, 'target_weight': tw}
