"""Batched heatmap peak decode (argmax + quarter offset): Hopper kernel +
plain version.

Port of `hourglass_pose_estimation_tpu/ops/pallas/decode.py::
decode_peaks_pallas`. The kernel is `csrc/decode.cu`; its header says
what bounds it. Like the TPU kernel it implements the corrected 0-based
convention only, i.e. it substitutes for
`decode_quarter_offset(zero_based=True)` before the inverse affine. The
kernel is the `torch.library` op `hpe::decode_peaks`, the one route to it
in eager and under `torch.export` alike.
"""

from __future__ import annotations

import math

import torch

from hourglass_pose_estimation_torch.ops.hopper import _build

MAX_CLUSTER = 8          # blocks an image: the portable thread-block cluster
TARGET_BLOCKS = 256      # blocks a launch aims at: about two per SM (132 on the H100)
MIN_LOADS = 4            # loads a thread has at least, where the image is small


def decode_peaks_reference(heatmaps: torch.Tensor):
    """Plain version: [B, H, W, J] -> (coords [B, J, 2] 0-based
    quarter-refined, maxvals [B, J]), first row-major argmax. NaN as in
    torch.argmax and jnp.argmax: the first NaN wins, its maxval is NaN,
    and a NaN gradient gives a NaN coordinate where the edge gate is
    open."""
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

    # jnp.sign's NaN for a NaN gradient (torch.sign gives 0)
    sign = lambda g: torch.where(g.isnan(), g, torch.sign(g))
    gx = at(0, 1) - at(0, -1)
    gy = at(1, 0) - at(-1, 0)
    ok = (px > 0) & (px < W - 1) & (py > 0) & (py < H - 1)
    zero = torch.zeros_like(gx)
    fx = px.to(torch.float32) + torch.where(ok, sign(gx) * 0.25, zero)
    fy = py.to(torch.float32) + torch.where(ok, sign(gy) * 0.25, zero)
    return torch.stack([fx, fy], dim=-1), maxv


def decode_schedule(B: int, H: int, W: int, J: int, aligned: bool = True):
    """The kernel's launch for [B, H, W, J] maps -> (K, rows, T, L): K
    blocks an image (one thread-block cluster, K <= MAX_CLUSTER), `rows`
    rows a block (block k reads rows [k rows, min(H, (k+1) rows)): every
    row once, the last slab may be shorter), T threads a block and L
    floats a load (16 bytes where the rows start on 16 bytes: W * J a
    multiple of 4 and `aligned`, the maps' address; else 1). L * T is a
    multiple of J, so each thread's lanes always meet the same joints.

    K makes the launch about TARGET_BLOCKS blocks (fewer where a thread
    would get fewer than MIN_LOADS loads): measured on an H100 at
    [B, 64, 64, 16] (PERF.md), 8 blocks of 256 threads an image are
    fastest at batch 1 to 32, where the read is mostly a chain of
    latencies, and 4 at batch 64, where it streams and fewer blocks leave
    fewer partials to merge."""
    if not (1 <= J <= 1024 and H >= 1 and W >= 1):
        raise ValueError(f'decode_peaks kernel: [{B}, {H}, {W}, {J}] outside its scope '
                         '(1 <= J <= 1024, H, W >= 1)')
    L = 4 if aligned and (W * J) % 4 == 0 else 1
    unit = J // math.gcd(J, L)            # T must be a multiple of this
    T = unit * max(1, 256 // unit)
    K = min(MAX_CLUSTER, H, max(1, -(-TARGET_BLOCKS // max(B, 1))),
            max(1, -(-H * W * J // (L * T * MIN_LOADS))))
    rows = -(-H // K)
    return -(-H // rows), rows, T, L


def _check_decode(heatmaps: torch.Tensor) -> None:
    """What the kernel takes."""
    if (heatmaps.dtype != torch.float32 or heatmaps.dim() != 4
            or not heatmaps.is_contiguous()):
        raise ValueError('decode_peaks kernel: heatmaps must be a contiguous '
                         f'[B, H, W, J] f32 tensor, got {heatmaps.dtype} '
                         f'{tuple(heatmaps.shape)}')


# The kernel as the `torch.library` op `hpe::decode_peaks`: the CPU kernel
# is the plain version, the CUDA kernel the launch (checks, counted on the
# public wrapper), and the fake gives the outputs' shapes (and, given meta
# tensors, refuses what the CUDA kernel would).
@torch.library.custom_op('hpe::decode_peaks', mutates_args=(), device_types='cpu')
def _decode_op(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return decode_peaks_reference(heatmaps)


@_decode_op.register_kernel('cuda')
def _(heatmaps):
    _check_decode(heatmaps)
    B, H, W, J = heatmaps.shape
    K, rows, T, L = decode_schedule(B, H, W, J, aligned=heatmaps.data_ptr() % 16 == 0)
    coords = torch.empty((B, J, 2), dtype=torch.float32, device=heatmaps.device)
    maxvals = torch.empty((B, J), dtype=torch.float32, device=heatmaps.device)
    err = _build.library().hpe_decode_peaks(
        heatmaps.data_ptr(), coords.data_ptr(), maxvals.data_ptr(),
        B, H, W, J, K, rows, T, L, _build.stream_for(heatmaps))
    _build.check(err, 'decode_peaks')
    decode_peaks.launches += 1
    return coords, maxvals


@_decode_op.register_fake
def _(heatmaps):
    if _build.on_meta(heatmaps):
        _check_decode(heatmaps)
    B, H, W, J = heatmaps.shape
    f32 = torch.float32
    return (heatmaps.new_empty((B, J, 2), dtype=f32),
            heatmaps.new_empty((B, J), dtype=f32))


def decode_peaks(heatmaps: torch.Tensor):
    """[B, H, W, J] f32 -> (coords [B, J, 2], maxvals [B, J]) (the op
    `hpe::decode_peaks`).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in `decode_peaks.launches`) or raises."""
    return torch.ops.hpe.decode_peaks(heatmaps)


decode_peaks.launches = 0
