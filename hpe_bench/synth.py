"""Seeded inputs made on the device: person-like figures with known joints,
and the model's weights.

The figures follow the program's synthetic dataset (`data/synthetic.py`:
uniform noise, a bright Gaussian blob at each visible joint coloured by its
left/right pair, the lower index of a pair always image-left, line
segments along the skeleton), drawn here in bulk from a torch.Generator
on the card instead of one numpy image at a time, so a pool of batches
costs a few kernels of set-up.

The weights are every parameter and BatchNorm statistic of a model, by
name: one draw of N(0, 1) over all of them, in sorted-name order, scaled
per kind of leaf. The program's model and the reference, whose names
agree, load the same tensors.
"""

from __future__ import annotations

import math

import torch

SKELETON = ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (6, 7), (7, 8), (8, 9),
            (10, 11), (11, 12), (12, 13), (13, 14), (14, 15))
FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))
PIXEL_STD = 200.0


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use (`stream`) of the run's seed:
    any whole seed, folded to 63 bits."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(stream)) % (2 ** 63 - 1))


def figures(n: int, res: int, gen: torch.Generator, device, n_joints: int = 16,
            chunk: int = 64):
    """n figures of res x res: (images uint8 [n, res, res, 3] BGR, joints
    f32 [n, J, 2] in pixels, vis f32 [n, J])."""
    J = n_joints
    img = torch.rand((n, res, res, 3), generator=gen, device=device) * 60.0
    joints = torch.rand((n, J, 2), generator=gen, device=device) * (0.6 * res) + 0.2 * res
    vis = (torch.rand((n, J), generator=gen, device=device) > 0.1).float()
    group = list(range(J))
    for a, b in FLIP_PAIRS:
        if a < J and b < J:
            group[b] = group[a]
            swap = joints[:, a, 0] > joints[:, b, 0]
            ja, jb = joints[:, a].clone(), joints[:, b].clone()
            joints[:, a] = torch.where(swap[:, None], jb, ja)
            joints[:, b] = torch.where(swap[:, None], ja, jb)
            va, vb = vis[:, a].clone(), vis[:, b].clone()
            vis[:, a] = torch.where(swap, vb, va)
            vis[:, b] = torch.where(swap, va, vb)
    color = torch.tensor([[40 + 215 * ((g * 37) % 7) / 6.0, 40 + 215 * ((g * 53) % 11) / 10.0,
                           40 + 215 * ((g * 29) % 13) / 12.0] for g in group],
                         dtype=torch.float32, device=device)                  # [J, 3]
    g1 = torch.arange(res, dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        jx, jy = joints[s:s + chunk, :, 0], joints[s:s + chunk, :, 1]      # [c, J]
        ex = torch.exp(-(g1[None, :, None] - jx[:, None, :]) ** 2 / 18.0)   # [c, W, J]
        ey = torch.exp(-(g1[None, :, None] - jy[:, None, :]) ** 2 / 18.0)   # [c, H, J]
        wj = vis[s:s + chunk, :, None] * color[None]                        # [c, J, 3]
        img[s:s + chunk] += torch.einsum('chj,cwj,cjk->chwk', ey, ex, wj)
    ts = torch.linspace(0, 1, 24, device=device)
    for a, b in SKELETON:
        if a >= J or b >= J:
            continue
        p = joints[:, a, None, :] * (1 - ts[None, :, None]) + joints[:, b, None, :] * ts[None, :, None]
        xi, yi = p[..., 0].long(), p[..., 1].long()                         # [n, 24]
        ok = (vis[:, a] > 0)[:, None] & (vis[:, b] > 0)[:, None]
        ok = ok & (xi >= 0) & (xi < res) & (yi >= 0) & (yi < res)
        flat = (torch.arange(n, device=device)[:, None] * res + yi) * res + xi
        add = torch.where(ok, 60.0, 0.0)[..., None].expand(n, 24, 3)
        img.view(n * res * res, 3).index_put_((flat.clamp(0, n * res * res - 1).reshape(-1),),
                                              add.reshape(-1, 3), accumulate=True)
    return img.clamp_(0, 255).to(torch.uint8), joints, vis


def canvas_batch(images, joints, vis) -> dict:
    """Figures as the program's raw canvas batch (canvas = the image, q 1,
    the person box the whole image)."""
    n, res = images.shape[0], images.shape[1]
    dev = images.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {'canvas': images, 'canvas_scale': torch.ones((n,), **f32),
            'canvas_offset': torch.zeros((n, 2), **f32),
            'center': torch.full((n, 2), res / 2.0, **f32),
            'scale': torch.full((n, 2), res / PIXEL_STD, **f32),
            'joints': joints, 'vis': vis, 'width': torch.full((n,), float(res), **f32)}


def weights(shapes: dict, seed: int, device, scale_of: dict = None) -> dict:
    """Seeded f32 tensors for `shapes` (name -> shape of every parameter and
    BatchNorm statistic): conv weights N(0, 1/fan_in), conv biases
    N(0, 0.01/fan_in), BatchNorm scales 1 + N(0, 0.01), shifts and running
    means N(0, 0.01), running variances 0.5 + |N(0, 1)| / 2. `scale_of`
    maps a name's ending to a factor for those BatchNorm scales (a
    residual block's last BatchNorm starts small in ResNet practice)."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    z = torch.randn((sum(sizes),), generator=generator(seed, 1, device), device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        v = z[at:at + size].view(shapes[name])
        at += size
        leaf = name.rsplit('.', 1)[-1]
        conv = name.rsplit('.', 1)[0] + '.weight'
        if leaf == 'weight' and len(shapes[name]) == 4:
            fan_in = math.prod(shapes[name][1:])
            out[name] = v * math.sqrt(1.0 / fan_in)
        elif leaf == 'bias' and len(shapes.get(conv, ())) == 4:
            out[name] = v * math.sqrt(0.01 / math.prod(shapes[conv][1:]))
        elif leaf == 'weight':
            factor = next((f for end, f in (scale_of or {}).items() if name.endswith(end)), 1.0)
            out[name] = factor * (1.0 + 0.1 * v)
        elif leaf in ('bias', 'running_mean'):
            out[name] = 0.1 * v
        elif leaf == 'running_var':
            out[name] = 0.5 + 0.5 * v.abs()
        else:
            raise ValueError(f'no seeded values for leaf {name!r}')
    return out
