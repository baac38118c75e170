"""Batched heatmap decoding on device.

Port of `hourglass_pose_estimation_tpu/ops/decode.py`: every decoder is
tensor math over [B, H, W, J] heatmaps on their own device, and the
coordinates come back mapped to source-image pixels.

  * `decode_quarter_offset` — argmax + 0.25-px step toward the higher
    neighbour, then the inverse affine (the reference's
    get_final_preds_v1). zero_based=True goes through
    `ops/hopper/decode.py::decode_peaks` (the kernel on a CUDA tensor, its
    plain version on the CPU); zero_based=False is the 1-based parity
    mode with the reference's lopsided stencil, tensor math.
  * `decode_dark` — DARK/Taylor: Gaussian blur, log, one Newton step on a
    finite-difference Hessian (get_final_preds_v2), in both bases.
  * `nms_heatmap`, `decode_nms_peaks`, `decode_nms_topk` — blur,
    threshold and 3x3 local-max suppression (the reference's visualizer
    decode), and its top-1 / top-k peaks.
  * `decode_simple_argmax` — thresholded argmax with the x4 stride
    (Estimator.post_process_heatmap_v1).

Only the 0-based quarter decode has a TPU kernel; the rest are XLA
programs in the JAX package and plain PyTorch here. The JAX package reads
the neighbours of each peak without gathers (shifted maps reduced against
the argmax one-hot, for the TPU); here they are gathered at the argmax,
which gives the same values. The blurs are separable sums of shifted
maps, so they are f32 whatever TF32 switches are set.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hourglass_pose_estimation_torch.ops.hopper.decode import decode_peaks
from hourglass_pose_estimation_torch.utils.evaluation import get_preds
from hourglass_pose_estimation_torch.utils.transforms import (
    batched_affine_transforms, batched_apply_affine)

_PAD = 3          # zero border of the maps the stencils read from


def get_preds_zero_based(heatmaps: torch.Tensor):
    """Clean 0-based per-joint argmax: [B, H, W, J] -> ([B, J, 2], [B, J])."""
    B, H, W, J = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, J)
    idx = torch.argmax(flat, dim=1)
    maxvals = flat.amax(dim=1)
    coords = torch.stack([(idx % W).to(torch.float32),
                          torch.div(idx, W, rounding_mode='floor').to(torch.float32)], -1)
    return coords, maxvals


def _peak_reader(maps: torch.Tensor, heatmaps: torch.Tensor):
    """-> at(dy, dx): [B, J] values of `maps` (zero outside, |d| <= 3) at
    (y + dy, x + dx), (x, y) each joint's first row-major argmax of
    `heatmaps`."""
    B, H, W, J = heatmaps.shape
    idx = torch.argmax(heatmaps.reshape(B, H * W, J), dim=1)       # [B, J]
    px, py = idx % W, torch.div(idx, W, rounding_mode='floor')
    Wp = W + 2 * _PAD
    padded = F.pad(maps, (0, 0, _PAD, _PAD, _PAD, _PAD)).reshape(B, -1, J)

    def at(dy: int, dx: int) -> torch.Tensor:
        lin = (py + _PAD + dy) * Wp + (px + _PAD + dx)
        return padded.gather(1, lin[:, None, :]).squeeze(1)
    return at


def _sign(g: torch.Tensor) -> torch.Tensor:
    """jnp.sign: NaN stays NaN (torch.sign gives 0)."""
    return torch.where(g.isnan(), g, torch.sign(g))


def _to_image(coords, centers, scales, size, device):
    B = coords.shape[0]
    centers = torch.as_tensor(centers, dtype=torch.float32, device=device)
    inv = batched_affine_transforms(
        centers, torch.as_tensor(scales, dtype=torch.float32, device=device),
        torch.zeros((B,), device=device), size, inv=True)
    return batched_apply_affine(coords, inv)


def decode_quarter_offset(heatmaps: torch.Tensor, centers, scales,
                          zero_based: bool = False, affine_size=None):
    """Argmax + quarter-pixel offset decode, batched.

    heatmaps [B, H, W, J]; centers [B, 2] and scales [B] or [B, 2] of the
    person boxes; affine_size (w, h), the size the inverse affine maps
    from, defaults to the heatmap size. zero_based=False reproduces the
    reference: get_preds' 1-based coordinates (x̂, ŷ+1) through the
    inverse affine, the stencil hm[ŷ][x̂] - hm[ŷ][x̂-2] and
    hm[ŷ+1][x̂-1] - hm[ŷ-1][x̂-1], the bounds 1 < p < size - 1; True is
    the corrected 0-based decode (the decode kernel).
    Returns (keypoints [B, J, 2] in source-image pixels, maxvals [B, J])."""
    B, H, W, J = heatmaps.shape
    hm = heatmaps.to(torch.float32)
    if zero_based:
        coords, maxvals = decode_peaks(hm.contiguous())
    else:
        coords, maxvals = get_preds(hm)
        at = _peak_reader(hm, hm)
        gx = at(0, 0) - at(0, -2)
        gy = at(1, -1) - at(-1, -1)
        px = torch.floor(coords[..., 0] + 0.5)
        py = torch.floor(coords[..., 1] + 0.5)
        ok = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
        offs = torch.stack([_sign(gx), _sign(gy)], dim=-1) * 0.25
        coords = coords + torch.where(ok[..., None], offs, torch.zeros_like(offs))
    size = affine_size if affine_size is not None else (W, H)
    return _to_image(coords, centers, scales, size, hm.device), maxvals


def _cv2_gaussian_kernel_1d(ksize: int) -> list:
    """cv2.getGaussianKernel(ksize, sigma=0): sigma = 0.3*((k-1)*0.5-1)+0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    vals = [math.exp(-((i - c) ** 2) / (2.0 * sigma * sigma)) for i in range(ksize)]
    s = sum(vals)
    return [v / s for v in vals]


def _separable(x: torch.Tensor, taps: list) -> torch.Tensor:
    """'valid' correlation of x [B, H, W, J] with `taps` along H, then
    along W: each a sum of shifted maps scaled by f32 taps, in tap order."""
    k = len(taps)
    w = torch.tensor(taps, dtype=torch.float32, device=x.device)
    H, W = x.shape[1] - k + 1, x.shape[2] - k + 1
    y = sum(w[i] * x[:, i:i + H] for i in range(k))
    return sum(w[i] * y[:, :, i:i + W] for i in range(k))


def gaussian_blur(heatmaps: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """Per-map Gaussian blur with zero padding, rescaled to each map's
    original max (the reference's inference.py:31-45). [B, H, W, J]."""
    orig_max = heatmaps.amax(dim=(1, 2), keepdim=True)
    pad = (kernel - 1) // 2
    x = F.pad(heatmaps.to(torch.float32), (0, 0, pad, pad, pad, pad))
    x = _separable(x, _cv2_gaussian_kernel_1d(kernel))
    new_max = x.amax(dim=(1, 2), keepdim=True)
    return x * (orig_max / new_max.clamp_min(1e-20))


def decode_dark(heatmaps: torch.Tensor, centers, scales,
                zero_based: bool = False, affine_size=None):
    """DARK (Taylor-expansion) decode, batched.

    zero_based=False reproduces the reference (inference.py:70-87),
    derivatives taken at its 1-based coordinates, one row below the peak;
    True takes them at the 0-based peak. The step applies where the peak
    is 2 pixels from every edge and the Hessian is not singular.
    affine_size as in `decode_quarter_offset`.
    Returns (keypoints [B, J, 2] in source-image pixels, maxvals [B, J])."""
    B, H, W, J = heatmaps.shape
    if zero_based:
        coords, maxvals = get_preds_zero_based(heatmaps)
    else:
        coords, maxvals = get_preds(heatmaps)
    # the log in f64, rounded to f32: the same bits on the card and the CPU,
    # whose f32 logs differ in the last bit, which the Newton step below
    # amplifies where the Hessian is nearly singular
    blurred = gaussian_blur(heatmaps, 11).clamp_min(1e-10)
    hm = torch.log(blurred.to(torch.float64)).to(torch.float32)
    px, py = torch.trunc(coords[..., 0]), torch.trunc(coords[..., 1])
    ok = (px > 1) & (px < W - 2) & (py > 1) & (py < H - 2)

    base_y = 0 if zero_based else 1
    read = _peak_reader(hm, heatmaps)
    g = lambda dy, dx: read(base_y + dy, dx)
    dxv = 0.5 * (g(0, 1) - g(0, -1))
    dyv = 0.5 * (g(1, 0) - g(-1, 0))
    dxx = 0.25 * (g(0, 2) - 2.0 * g(0, 0) + g(0, -2))
    dxy = 0.25 * (g(1, 1) - g(-1, 1) - g(1, -1) + g(-1, -1))
    dyy = 0.25 * (g(2, 0) - 2.0 * g(0, 0) + g(-2, 0))

    det = dxx * dyy - dxy * dxy
    ok = ok & (det != 0.0)
    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    # -H^{-1} @ grad for the 2x2 Hessian
    off_x = -(dyy * dxv - dxy * dyv) / safe_det
    off_y = -(-dxy * dxv + dxx * dyv) / safe_det
    offs = torch.stack([off_x, off_y], dim=-1)
    coords = coords + torch.where(ok[..., None], offs, torch.zeros_like(offs))
    size = affine_size if affine_size is not None else (W, H)
    return _to_image(coords, centers, scales, size, heatmaps.device), maxvals


def _scipy_gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> list:
    """scipy.ndimage.gaussian_filter's 1-D kernel: radius =
    int(truncate*sigma + 0.5), exp(-0.5 (x/sigma)^2), normalized."""
    radius = int(truncate * sigma + 0.5)
    vals = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(vals)
    return [v / s for v in vals]


def _symmetric_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by `pad` on each side, numpy's
    'symmetric' (scipy's 'reflect'): the edge element repeats."""
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def nms_heatmap(heatmaps: torch.Tensor, sigma: float = 1.0, window: int = 3,
                threshold: float = 1e-6) -> torch.Tensor:
    """Batched blur + threshold + local-max suppression: scipy's
    gaussian_filter(sigma) with its 'reflect' border, values below
    `threshold` set to 0, then only the pixels equal to the maximum of
    their `window` x `window` neighbourhood (outside the map counts as
    -inf, the SAME window) kept. [B, H, W, J] -> f32 [B, H, W, J]."""
    B, H, W, J = heatmaps.shape
    taps = _scipy_gaussian_kernel_1d(sigma)
    pad = (len(taps) - 1) // 2
    x = heatmaps.to(torch.float32)
    x = x[:, _symmetric_index(H, pad, x.device)][:, :, _symmetric_index(W, pad, x.device)]
    x = _separable(x, taps)
    x = torch.where(x < threshold, torch.zeros_like(x), x)
    lo = (window - 1) // 2
    hi = window - 1 - lo
    nchw = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi), value=float('-inf'))
    local_max = F.max_pool2d(nchw, window, stride=1).permute(0, 2, 3, 1)
    return x * (x == local_max)


def decode_nms_peaks(heatmaps: torch.Tensor, sigma: float = 1.0, window: int = 3,
                     threshold: float = 1e-6) -> torch.Tensor:
    """Top NMS peak per joint: [B, H, W, J] -> [B, J, 3] (x, y, conf), the
    first row-major maximum of the suppressed map; an all-zero map decodes
    to (0, 0, 0)."""
    B, H, W, J = heatmaps.shape
    flat = nms_heatmap(heatmaps, sigma, window, threshold).reshape(B, H * W, J)
    conf, idx = flat.max(dim=1)
    x = (idx % W).to(torch.float32)
    y = torch.div(idx, W, rounding_mode='floor').to(torch.float32)
    return torch.stack([x, y, conf], dim=-1)


def decode_nms_topk(heatmaps: torch.Tensor, k: int = 4, sigma: float = 1.0,
                    window: int = 3, threshold: float = 1e-6):
    """The k strongest NMS peaks per joint -> ([B, J, k, 2] (x, y), [B, J, k]
    conf), strongest first and, among equal values, the lower flat index
    first (jax.lax.top_k's order); slots beyond the real peaks carry
    conf 0."""
    B, H, W, J = heatmaps.shape
    flat = nms_heatmap(heatmaps, sigma, window, threshold).reshape(B, H * W, J)
    conf, idx = torch.sort(flat.transpose(1, 2), dim=-1, descending=True, stable=True)
    conf, idx = conf[..., :k], idx[..., :k]
    x = (idx % W).to(torch.float32)
    y = torch.div(idx, W, rounding_mode='floor').to(torch.float32)
    return torch.stack([x, y], dim=-1), conf


def decode_simple_argmax(heatmaps: torch.Tensor, input_size, output_size,
                         threshold: float = 0.02):
    """Thresholded 0-based argmax with the x4 stride, scaled from
    input_size to output_size (w, h) -> (int32 [B, J, 2] keypoints,
    maxvals [B, J]); joints whose max is not above `threshold` give
    (0, 0)."""
    B, H, W, J = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, J)
    idx = torch.argmax(flat, dim=1)
    maxv = flat.amax(dim=1)
    keep = maxv > threshold
    zero = torch.zeros((), dtype=torch.float32, device=heatmaps.device)
    x = torch.where(keep, (idx % W).to(torch.float32), zero)
    y = torch.where(keep, torch.div(idx, W, rounding_mode='floor').to(torch.float32), zero)
    scale_x = output_size[0] / input_size[0]
    scale_y = output_size[1] / input_size[1]
    kps = torch.stack([x * scale_x * 4.0, y * scale_y * 4.0], dim=-1)
    return kps.to(torch.int32), maxv
