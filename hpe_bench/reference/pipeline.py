"""Plain reference of the device input pipeline, the loss and the optimizer
of a train step (the reference repository's MPII augmentation, Newell et
al.'s per-stack heatmap loss, RMSprop), written apart from the program.

  * draws: per step, one U(0, 1) gates the flip (p <= 0.5) and the
    rotation (p <= 0.6); the scale is jittered by clip(N(1, sf), 1 +- sf),
    the rotation is clip(N(0, rf), +-2 rf) degrees. They come from a
    torch.Generator on the batch's device seeded from (run seed, step)
    through numpy's SeedSequence, in the order rand, randn, randn over the
    batch;
  * the crop: the similarity that maps the (jittered) person box, 200 px
    a scale unit, rotated, onto the R x R input, composed with the flip
    and the canvas's own scale and offset, sampled bilinearly from the
    uint8 canvas with zeros outside; then (x / 255 - mean) / std;
  * the targets: each joint through the same map, quantised to the
    heatmap grid (int(x / stride + 0.5)), a Gaussian of sigma inside its
    (6 sigma + 1) window where the joint is visible and its window meets
    the map (the weight is 0 otherwise);
  * the loss: for each stack and joint, 0.5 * mean((w * (pred - gt))^2),
    averaged over the joints and summed over the stacks;
  * RMSprop: v = 0.99 v + 0.01 g^2, p -= lr * g / (sqrt(v) + 1e-8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PIXEL_STD = 200.0


def step_generator(seed: int, step: int, device) -> torch.Generator:
    s = np.random.SeedSequence((int(seed), int(step))).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def draws(seed: int, step: int, scales: torch.Tensor, sf: float, rf: float):
    """(scales [B, 2], rots [B], flips [B]) of step `step`'s batch."""
    n, dev = scales.shape[0], scales.device
    g = step_generator(seed, step, dev)
    prob = torch.rand((n,), generator=g, device=dev)
    mult = torch.clamp(torch.randn((n,), generator=g, device=dev) * sf + 1.0, 1.0 - sf, 1.0 + sf)
    rots = torch.clamp(torch.randn((n,), generator=g, device=dev) * rf, -2.0 * rf, 2.0 * rf)
    rots = torch.where(prob <= 0.6, rots, torch.zeros_like(rots))
    return scales * mult[:, None], rots, prob <= 0.5


def crop_affine(centers, scales, rots, R: int, inv: bool):
    """[B, 2, 3] maps of the person box onto the R x R crop (or back)."""
    k = R / (scales[:, 0] * PIXEL_STD)
    r = -rots * (math.pi / 180.0)
    cs, sn = torch.cos(r), torch.sin(r)
    L = k[:, None, None] * torch.stack([torch.stack([cs, -sn], -1),
                                        torch.stack([sn, cs], -1)], -2)
    dst = torch.full_like(centers, R * 0.5)
    if inv:
        det = L[:, 0, 0] * L[:, 1, 1] - L[:, 0, 1] * L[:, 1, 0]
        Li = torch.stack([torch.stack([L[:, 1, 1], -L[:, 0, 1]], -1),
                          torch.stack([-L[:, 1, 0], L[:, 0, 0]], -1)], -2) / det[:, None, None]
        return torch.cat([Li, (centers - apply_linear(Li, dst))[:, :, None]], -1)
    return torch.cat([L, (dst - apply_linear(L, centers))[:, :, None]], -1)


def apply_linear(L, pts):
    """[B, 2, 2] applied to [B, ..., 2]."""
    idx = (slice(None),) + (None,) * (pts.dim() - 2)
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([L[idx + (0, 0)] * x + L[idx + (0, 1)] * y,
                        L[idx + (1, 0)] * x + L[idx + (1, 1)] * y], -1)


def warp(images: torch.Tensor, inv: torch.Tensor, R: int) -> torch.Tensor:
    """uint8 [B, H, W, C] sampled at inv @ (x, y, 1) for each crop pixel,
    bilinear, zero outside -> f32 [B, R, R, C]."""
    B, H, W, C = images.shape
    dev = images.device
    xs = torch.arange(R, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(R, dtype=torch.float32, device=dev)[None, :, None]
    t = inv[:, :, :, None, None]
    sx = t[:, 0, 0] * xs + t[:, 0, 1] * ys + t[:, 0, 2]
    sy = t[:, 1, 0] * xs + t[:, 1, 1] * ys + t[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = images.reshape(B, H * W, C).float()

    def tap(dy, dx):
        xi, yi = x0.long() + dx, y0.long() + dy
        inside = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, R * R, 1).expand(B, R * R, C)
        v = torch.gather(flat, 1, idx).reshape(B, R, R, C)
        return torch.where(inside, v, torch.zeros((), device=dev))

    top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
    bot = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
    return top * (1 - fy) + bot * fy


def render(joints, vis, out_res: int, R: int, sigma: int):
    """Targets [B, h, h, J] f32 and weights [B, J] from crop-pixel joints."""
    stride = R / out_res
    mu = torch.trunc(joints / stride + 0.5).to(torch.int64)
    tmp = int(3 * sigma)
    off = ((mu - tmp >= out_res) | (mu + tmp + 1 < 0)).any(-1)
    w = torch.where(off, torch.zeros_like(vis), vis)
    g = torch.arange(out_res, device=joints.device)
    dx = g[None, None, :, None] - mu[:, None, None, :, 0]
    dy = g[None, :, None, None] - mu[:, None, None, :, 1]
    val = torch.exp(-(dx.float() ** 2 + dy.float() ** 2) / (2.0 * sigma ** 2))
    keep = (dx.abs() <= tmp) & (dy.abs() <= tmp) & (w > 0.5)[:, None, None, :]
    return torch.where(keep, val, torch.zeros((), device=joints.device)), w


def augment(raw: dict, d, spec: dict):
    """A raw canvas batch and its draws -> (image [B, R, R, 3] normalised,
    target [B, h, h, J], weight [B, J])."""
    R, out_res = spec['inp_res'], spec['out_res']
    scales, rots, flips = d
    q = raw['canvas_scale'].float()
    ox, oy = raw['canvas_offset'][:, 0].float(), raw['canvas_offset'][:, 1].float()
    width = raw['width'].float()
    c = raw['center'].float()
    c = torch.stack([torch.where(flips, width - c[:, 0] - 1.0, c[:, 0]), c[:, 1]], -1)
    perm = torch.as_tensor(spec['flip_perm'], device=c.device)
    j, v = raw['joints'].float(), raw['vis'].float()
    j = torch.where(flips[:, None, None],
                    torch.stack([width[:, None] - j[:, perm, 0] - 1.0, j[:, perm, 1]], -1), j)
    v = torch.where(flips[:, None], v[:, perm], v)
    fwd = crop_affine(c, scales, rots, R, inv=False)
    inv = crop_affine(c, scales, rots, R, inv=True)
    sgn = torch.where(flips, -1.0, 1.0)
    shift = torch.where(flips, width - 1.0, torch.zeros_like(width))
    m = torch.stack([
        torch.stack([q * sgn * inv[:, 0, 0], q * sgn * inv[:, 0, 1],
                     q * (sgn * inv[:, 0, 2] + shift - ox)], -1),
        torch.stack([q * inv[:, 1, 0], q * inv[:, 1, 1], q * (inv[:, 1, 2] - oy)], -1)], 1)
    img = warp(raw['canvas'], m, R)
    mean = torch.tensor(spec['mean'], device=img.device)
    std = torch.tensor(spec['std'], device=img.device)
    img = (img / 255.0 - mean) / std
    jc = apply_linear(fwd[:, :, :2], j) + fwd[:, None, :, 2]
    target, w = render(jc, v, out_res, R, spec['sigma'])
    return img, target, w


def loss_fn(outs, target, w):
    diff = (outs - target[None]) * w[None, :, None, None, :]
    return (0.5 * (diff * diff).mean(dim=(1, 2, 3))).mean(dim=1).sum()


def rmsprop_(params, grads, sq, lr: float, alpha: float = 0.99, eps: float = 1e-8):
    """One RMSprop step in place (sq: the running E[g^2], zeros at first)."""
    with torch.no_grad():
        for p, g, v in zip(params, grads, sq):
            v.mul_(alpha).addcmul_(g, g, value=1.0 - alpha)
            p.sub_(lr * g / (v.sqrt() + eps))
