"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from hourglass_pose_estimation_torch.export import make_inference_fn
from hourglass_pose_estimation_torch.models import get_model
from hourglass_pose_estimation_torch.models.modules import Bottleneck, Hourglass
from hourglass_pose_estimation_torch.ops.hopper import (
    bottleneck_reference, decode_peaks, decode_peaks_reference,
    fused_bottleneck, upsample2x_add, upsample2x_add_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (and nvcc to build the kernels)')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize('shape', [(2, 16, 16), (1, 17, 24), (3, 64, 64)])
def test_bottleneck_kernel_matches_plain(dev, shape):
    torch.manual_seed(0)
    blk = Bottleneck(256, 128).to(dev)
    prm = blk.fused_params()
    x = torch.randn(*shape, 256, device=dev).to(torch.bfloat16)
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, prm)
    assert fused_bottleneck.launches == before + 1
    # same rounding points; f32 summation order differs. The residual
    # branch (out - x) is what the kernel computes; x dominates the output
    ref = bottleneck_reference(x, prm)
    assert _rel(got.float() - x.float(), ref.float() - x.float()) < 1e-2
    assert _rel(got, ref) < 1e-2


@pytest.mark.parametrize('h,c,dtype', [(12, 32, torch.float32),
                                       (3, 8, torch.bfloat16),
                                       (32, 256, torch.bfloat16)])
def test_upsample_kernel_is_exact(dev, h, c, dtype):
    low = torch.randn(2, h, h + 1, c, device=dev).to(dtype)
    skip = torch.randn(2, 2 * h, 2 * h + 2, c, device=dev).to(dtype)
    assert torch.equal(upsample2x_add(low, skip),
                       upsample2x_add_reference(low, skip))


def test_decode_kernel_is_exact(dev):
    hm = torch.rand(4, 16, 20, 17, device=dev)
    hm[0, 3, 3, 0] = hm[0, 5, 1, 0] = 9.0
    hm[1, 0, 4, 1] = 9.0
    hm[2, :, :, 2] = 0.0
    got, ref = decode_peaks(hm), decode_peaks_reference(hm)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_kernel_wrappers_raise_on_layouts_they_do_not_take(dev):
    x = torch.randn(1, 256, 16, 16, device=dev).to(torch.bfloat16)
    prm = Bottleneck(256, 128).to(dev).fused_params()
    with pytest.raises(ValueError):
        fused_bottleneck(x.permute(0, 2, 3, 1)[:, :, :, :255], prm)
    with pytest.raises(ValueError):
        decode_peaks(torch.rand(1, 8, 8, 4, device=dev).to(torch.float16))


def test_inference_fn_kernel_path_matches_plain_path(dev):
    torch.manual_seed(0)
    kw = dict(num_stacks=1, num_classes=16)
    frames = np.random.RandomState(0).randint(0, 256, (2, 96, 80, 3)).astype(np.uint8)
    model = get_model('hg', device='cpu', fuse_block=True, fuse_upsample=True,
                      **kw)
    outs = []
    for fuse in (True, False):
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.fuse_block = fuse
            elif isinstance(m, Hourglass):
                m.fuse_upsample = fuse
        fn = make_inference_fn(model, None, fold_bn=True, device=dev,
                               preprocess=((0.4, 0.44, 0.47), (0.23, 0.23, 0.24)),
                               input_res=128)
        outs.append(fn(frames))
    assert outs[0].shape == (2, 32, 32, 16)
    assert _rel(outs[0], outs[1]) < 5e-2
