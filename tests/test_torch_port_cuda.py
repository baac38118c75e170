"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hourglass_pose_estimation_torch.data import Synthetic, make_spec
from hourglass_pose_estimation_torch.export import make_inference_fn
from hourglass_pose_estimation_torch.models import get_model
from hourglass_pose_estimation_torch.models.modules import Bottleneck, Hourglass
from hourglass_pose_estimation_torch.models.hourglass import HourglassNet
from hourglass_pose_estimation_torch.ops.heatmap import render_preamble
from hourglass_pose_estimation_torch.ops.hopper import (
    KERNEL_WRAPPERS, bottleneck_backward_reference, bottleneck_reference,
    decode_peaks, decode_peaks_reference, fused_bottleneck,
    fused_bottleneck_chunked, fused_bottleneck_image, launch_counts, maxpool2x2,
    maxpool2x2_bwd, maxpool2x2_bwd_first, maxpool2x2_bwd_first_reference,
    maxpool2x2_bwd_reference, maxpool2x2_fwd,
    maxpool2x2_reference, render_gaussian, render_gaussian_reference,
    upsample2x_add, upsample2x_add_bwd, upsample2x_add_bwd_reference,
    upsample2x_add_reference)
from hourglass_pose_estimation_torch.runner import (
    init_state, make_optimizer, make_train_step)
from hourglass_pose_estimation_torch.utils import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (and nvcc to build the kernels)')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def launched(wrapper) -> int:
    """The launches of one kernel wrapper since the last tracing.reset()."""
    return launch_counts()[wrapper.__name__]


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize('shape', [(2, 16, 16), (1, 17, 24), (3, 64, 64), (1, 64, 64),
                                   (64, 16, 16)])
def test_bottleneck_kernel_matches_plain(dev, shape):
    """Both schedules against the plain version, and against each other:
    the same products in the same k-order per pixel, so the same bits. Batch
    1 at 64^2 is the serving batch-1 path; 64 images of 16^2 fill the card
    with small blocks."""
    torch.manual_seed(0)
    blk = Bottleneck(256, 128).to(dev)
    prm = blk.fused_params()
    x = torch.randn(*shape, 256, device=dev).to(torch.bfloat16)
    ref = bottleneck_reference(x, prm)
    outs = {}
    for impl, wrapper in (('image', fused_bottleneck_image),
                          ('chunked', fused_bottleneck_chunked)):
        before = launched(wrapper)
        outs[impl] = got = fused_bottleneck(x, prm, impl=impl)
        assert launched(wrapper) == before + 1
        # same rounding points; f32 summation order differs. The residual
        # branch (out - x) is what the kernel computes; x dominates the output
        assert _rel(got.float() - x.float(), ref.float() - x.float()) < 1e-2
        assert _rel(got, ref) < 1e-2
    assert torch.equal(outs['image'], outs['chunked'])


@pytest.mark.parametrize('shape', [(2, 12, 12), (3, 17, 24), (2, 64, 64), (5, 32, 32)])
def test_cluster_bottleneck_kernel_matches_chunked_and_plain(dev, shape):
    """The cluster kernel at H = 12 (an odd row tile, TR 3 and 4 blocks a
    cluster), H = 17 (prime: one block per image) and at two flagship
    shapes, bit-equal to the chunked kernel."""
    from hourglass_pose_estimation_torch.ops.hopper import bottleneck as bk
    torch.manual_seed(1)
    prm = Bottleneck(256, 128).to(dev).fused_params()
    x = torch.randn(*shape, 256, device=dev).to(torch.bfloat16)
    tr, r = bk.image_schedule(shape[0], shape[1], shape[2],
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    assert tr * r == shape[1] and 1 <= r <= bk.MAX_CLUSTER
    got = fused_bottleneck_image(x, prm)
    ref = bottleneck_reference(x, prm)
    assert _rel(got.float() - x.float(), ref.float() - x.float()) < 1e-2
    assert torch.equal(got, fused_bottleneck_chunked(x, prm))


def test_cluster_bottleneck_refuses_more_than_eight_blocks(dev):
    """128 rows of 128 pixels: a t2 window that fits in shared memory beside
    the weight ring holds at most 3 rows, so a cluster would need more than
    8 blocks; the chunked kernel runs 64 blocks of 2 rows."""
    torch.manual_seed(2)
    prm = Bottleneck(256, 128).to(dev).fused_params()
    x = torch.randn(1, 128, 128, 256, device=dev).to(torch.bfloat16)
    before = launched(fused_bottleneck_image)
    with pytest.raises(ValueError, match="impl='chunked'"):
        fused_bottleneck(x, prm, impl='image')
    assert launched(fused_bottleneck_image) == before
    got = fused_bottleneck(x, prm, impl='chunked')
    ref = bottleneck_reference(x, prm)
    assert _rel(got.float() - x.float(), ref.float() - x.float()) < 1e-2


@pytest.mark.parametrize('impl', ['image', 'chunked'])
def test_bottleneck_kernel_is_deterministic(dev, impl):
    """Two launches on the same inputs give the same bits: each output is
    summed in a fixed order, with no atomics."""
    torch.manual_seed(3)
    prm = Bottleneck(256, 128).to(dev).fused_params()
    x = torch.randn(8, 32, 32, 256, device=dev).to(torch.bfloat16)
    assert torch.equal(fused_bottleneck(x, prm, impl=impl), fused_bottleneck(x, prm, impl=impl))


def test_f32_config_eval_step_runs_standard_blocks(dev, tmp_path):
    """configs/train_synthetic_tiny.yaml (precision f32, MODEL.fuse_block at
    its default, on): the Trainer's validation pass runs on the card. The
    fused bottleneck takes bf16 only, so the f32 model's blocks take the
    standard path: no bottleneck launch (it raised ValueError at the first
    validation batch when the model routed f32 blocks to the kernel)."""
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.runner import Trainer
    cfg = load_config(str(Path(__file__).resolve().parents[1] / 'configs' /
                          'train_synthetic_tiny.yaml'),
                      overrides=[f'COMMON.checkpoint_dir={tmp_path}'])
    assert cfg.model.fuse_block and cfg.train.precision == 'f32'
    t = Trainer(cfg, verbose=False, device=dev)
    tracing.reset()
    loss, acc = t._evaluate()
    assert np.isfinite([loss, acc]).all()
    assert launched(fused_bottleneck_chunked) == launched(fused_bottleneck_image) == 0
    assert launched(upsample2x_add) > 0


@pytest.mark.parametrize('h,c,dtype', [(12, 32, torch.float32),
                                       (3, 8, torch.bfloat16),
                                       (32, 256, torch.bfloat16)])
def test_upsample_kernel_is_exact(dev, h, c, dtype):
    low = torch.randn(2, h, h + 1, c, device=dev).to(dtype)
    skip = torch.randn(2, 2 * h, 2 * h + 2, c, device=dev).to(dtype)
    assert torch.equal(upsample2x_add(low, skip),
                       upsample2x_add_reference(low, skip))


def _same(a, b):
    """Equal bits, NaN where the other has NaN."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(nan=0.0), b.nan_to_num(nan=0.0)))


@pytest.mark.parametrize('b,h,w,j', [(4, 16, 20, 17), (1, 64, 64, 16), (64, 64, 64, 16),
                                     (1, 64, 64, 17), (64, 64, 64, 17), (3, 12, 20, 17),
                                     (2, 12, 64, 16), (2, 13, 64, 16), (2, 12, 13, 17),
                                     (37, 64, 64, 16), (48, 64, 64, 16), (60, 64, 64, 17)])
def test_decode_kernel_is_exact(dev, b, h, w, j):
    """Batch 1 and 64, the partial serving batches 37, 48 and 60
    (clusters of 7, 6 and 5 blocks), J = 16 and 17, H = 12 and 13 (13
    rows in slabs of 4 leave the last block 1), W * J odd (4-byte loads),
    with planted ties (one across the first two blocks' slabs), edges, a
    flat map and NaN; the kernel equals the plain version bit for bit."""
    from hourglass_pose_estimation_torch.ops.hopper.decode import decode_schedule
    K, rows, _, _ = decode_schedule(b, h, w, j)
    gen = torch.Generator().manual_seed(b * 1000 + h * 10 + j)
    hm = torch.rand(b, h, w, j, generator=gen)
    hm[0, 3, 3, 0] = hm[0, 5, 1, 0] = 9.0
    hm[-1, 0, 4, 1] = 9.0
    hm[0, :, :, 2] = 0.0
    if K > 1:
        hm[-1, rows - 1, w - 2, 3] = hm[-1, rows, 1, 3] = 9.0
    hm[-1, h // 2, w // 2, 4] = float('nan')
    hm = hm.to(dev)
    before = launched(decode_peaks)
    got, ref = decode_peaks(hm), decode_peaks_reference(hm)
    assert launched(decode_peaks) == before + 1
    assert _same(got[0], ref[0]) and _same(got[1], ref[1])
    assert got[0][0, 0].tolist() == [3.0 + float(torch.sign(hm[0, 3, 4, 0] - hm[0, 3, 2, 0])) * 0.25,
                                     3.0 + float(torch.sign(hm[0, 4, 3, 0] - hm[0, 2, 3, 0])) * 0.25]
    if K > 1:
        assert got[0][-1, 3, 1].item() in (rows - 1.25, rows - 1.0, rows - 0.75)


def test_decode_kernel_ranks_nan_first(dev):
    """torch.argmax's and the XLA decoder's NaN rule: a NaN among numbers
    wins over a larger finite peak, the first of two NaNs wins and its NaN
    neighbour makes its x NaN, an all-NaN joint decodes to (0, 0) with
    maxval NaN. The first-generation kernel returned the largest finite
    value and its position, and a sign of 0 for a NaN gradient."""
    nan = float('nan')
    hm = torch.rand(2, 16, 16, 16, generator=torch.Generator().manual_seed(5))
    hm[0, 9, 9, 0] = 5.0
    hm[0, 3, 4, 0] = nan
    hm[0, 7, 7, 1] = hm[0, 7, 8, 1] = nan
    hm[1, :, :, 2] = nan
    hm = hm.to(dev)
    (gc, gm), (rc, rm) = decode_peaks(hm), decode_peaks_reference(hm)
    assert _same(gc, rc) and _same(gm, rm)
    assert gm[0, 0].isnan() and gc[0, 0, 0].item() == 4.0 + float(torch.sign(hm[0, 3, 5, 0] - hm[0, 3, 3, 0])) * 0.25
    assert gc[0, 1, 0].isnan() and not gc[0, 1, 1].isnan()
    assert gm[1, 2].isnan() and gc[1, 2].tolist() == [0.0, 0.0]


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
            elif isinstance(m, (Hourglass, HourglassNet)):
                m.fuse_upsample = fuse
        fn = make_inference_fn(model, None, fold_bn=True, device=dev,
                               preprocess=((0.4, 0.44, 0.47), (0.23, 0.23, 0.24)),
                               input_res=128)
        outs.append(fn(frames))
    assert outs[0].shape == (2, 32, 32, 16)
    assert _rel(outs[0], outs[1]) < 5e-2


@pytest.mark.parametrize('b,h,c,dtype', [(2, 12, 32, torch.float32),
                                         (1, 3, 8, torch.bfloat16),
                                         (4, 16, 256, torch.bfloat16)])
def test_upsample_backward_kernel_is_exact(dev, b, h, c, dtype):
    g = torch.randn(b, 2 * h, 2 * h + 2, c, device=dev).to(dtype)
    before = launched(upsample2x_add_bwd)
    got = upsample2x_add_bwd(g)
    assert launched(upsample2x_add_bwd) == before + 1
    assert torch.equal(got, upsample2x_add_bwd_reference(g))


def _tied(b, h, c, dtype, dev):
    x = torch.randn(b, h, h, c)
    x[0, 0:2, 0:2, :] = 1.0                              # 4-way
    x[0, 2:4, 0:2, 0] = torch.tensor([[2.0, 2.0], [2.0, 0.0]])
    x[-1, 0:2, 2:4, 1] = torch.tensor([[0.5, -1.0], [0.5, 0.0]])
    return x.to(dev, dtype)


@pytest.mark.parametrize('b,h,c,dtype', [(2, 12, 256, torch.bfloat16),
                                         (2, 24, 128, torch.bfloat16),
                                         (3, 8, 8, torch.float32)])
def test_pool_kernels_are_exact(dev, b, h, c, dtype):
    x = _tied(b, h, c, dtype, dev)
    g = torch.randn(b, h // 2, h // 2, c, device=dev).to(dtype)
    out = maxpool2x2_fwd(x)
    assert torch.equal(out, maxpool2x2_reference(x))
    assert torch.equal(out, torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1))
    dx = maxpool2x2_bwd(x, g)
    assert torch.equal(dx, maxpool2x2_bwd_reference(x, g))
    assert torch.equal(dx[0, 0:2, 0:2, :], (g[0, 0, 0].float() / 4).to(dtype).expand(2, 2, -1))


@pytest.mark.parametrize('b,h,c,dtype', [(2, 12, 256, torch.bfloat16),
                                         (2, 24, 128, torch.bfloat16),
                                         (3, 8, 8, torch.float32)])
def test_pool_first_max_kernel_matches_max_pool2d_autograd(dev, b, h, c, dtype):
    """The first-maximum backward on the planted ties: equal to its plain
    version and to F.max_pool2d's gradient (the JAX model's nn.max_pool
    convention), through the wrapper and through the autograd Function."""
    x = _tied(b, h, c, dtype, dev)
    g = torch.randn(b, h // 2, h // 2, c, device=dev).to(dtype)
    before = launched(maxpool2x2_bwd_first)
    dx = maxpool2x2_bwd_first(x, g)
    assert launched(maxpool2x2_bwd_first) == before + 1
    assert torch.equal(dx, maxpool2x2_bwd_first_reference(x, g))
    xn = x.permute(0, 3, 1, 2).detach().requires_grad_()
    torch.nn.functional.max_pool2d(xn, 2, 2).backward(g.permute(0, 3, 1, 2))
    assert torch.equal(dx, xn.grad.permute(0, 2, 3, 1))
    assert torch.equal(dx[0, 0, 0], g[0, 0, 0]) and not dx[0, 0:2, 0:2].flatten(0, 1)[1:].any()
    xa = x.detach().requires_grad_()
    maxpool2x2(xa).backward(g)
    assert torch.equal(xa.grad, dx)


@pytest.mark.parametrize('b,hm,img,j,sigma', [
    (4, (16, 16), (64, 64), 16, 1), (4, (16, 16), (64, 64), 16, 2),
    (3, (12, 20), (48, 80), 17, 1), (2, (13, 20), (52, 80), 17, 2),
    (1, (64, 64), (256, 256), 16, 1), (64, (64, 64), (256, 256), 17, 1),
    (2, (64, 64), (256, 256), 16, 2)])
def test_render_kernel_within_one_ulp(dev, b, hm, img, j, sigma):
    """J = 16 and 17, a 12x20 map and a 13-wide one at J = 17 (W * J = 221:
    rows that do not start on 16 bytes), sigma 1 and 2, batch 1 and 64:
    the same windows, at most 1 ulp from the plain version (expf against
    torch.exp), equal at sigma 1."""
    gen = torch.Generator().manual_seed(b * 100 + j)
    W, H = img
    joints = torch.rand(b, j, 2, generator=gen) * torch.tensor([1.4 * W, 1.4 * H]) \
        - torch.tensor([0.2 * W, 0.2 * H])
    joints[0, :3] = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [-20.0, H + 6.0]])
    vis = (torch.rand(b, j, generator=gen) > 0.2).float()
    mu, w = render_preamble(joints.to(dev), vis.to(dev), hm, img, sigma)
    before = launched(render_gaussian)
    got = render_gaussian(mu, w, hm, sigma)
    assert launched(render_gaussian) == before + 1
    ref = render_gaussian_reference(mu, w, hm, sigma)
    assert got.shape == (b, hm[1], hm[0], j)
    assert torch.equal(got > 0, ref > 0) and bool((got > 0).any())
    ulps = int((got.view(torch.int32) - ref.view(torch.int32)).abs().max())
    assert ulps <= (0 if sigma == 1 else 1)


def test_gradients_flow_through_the_autograd_functions(dev):
    torch.manual_seed(0)
    low = torch.randn(2, 8, 8, 256, device=dev).to(torch.bfloat16).requires_grad_()
    skip = torch.randn(2, 16, 16, 256, device=dev).to(torch.bfloat16).requires_grad_()
    g = torch.randn(2, 16, 16, 256, device=dev).to(torch.bfloat16)
    upsample2x_add(low, skip).backward(g)
    assert torch.equal(low.grad, upsample2x_add_bwd_reference(g))
    assert torch.equal(skip.grad, g)

    x = _tied(2, 16, 256, torch.bfloat16, dev).requires_grad_()
    gp = torch.randn(2, 8, 8, 256, device=dev).to(torch.bfloat16)
    maxpool2x2(x, ties='split').backward(gp)
    assert torch.equal(x.grad, maxpool2x2_bwd_reference(x.detach(), gp))
    x.grad = None
    maxpool2x2(x).backward(gp)
    assert torch.equal(x.grad, maxpool2x2_bwd_first_reference(x.detach(), gp))

    blk = Bottleneck(256, 128, fuse_block=True).to(dev)
    xb = torch.randn(2, 16, 16, 256, device=dev).to(torch.bfloat16).requires_grad_()
    gb = torch.randn(2, 16, 16, 256, device=dev).to(torch.bfloat16)
    prm = blk.fused_params()
    calls = fused_bottleneck.backward_calls
    fused_bottleneck(xb, prm).backward(gb)
    assert fused_bottleneck.backward_calls == calls + 1
    dx, _ = bottleneck_backward_reference(xb.detach(), prm, gb)
    assert torch.equal(xb.grad, dx)
    for name in ('bn1.weight', 'bn2.bias', 'conv1.weight', 'conv2.weight', 'conv3.bias'):
        grad = blk.get_parameter(name).grad
        assert grad is not None and bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def test_small_train_step_launches_the_training_kernels(dev):
    ds = Synthetic(True, num_samples=4, inp_res=64, out_res=16, sigma=1)
    raw, spec = ds.canvas_batch(range(4), canvas=64), make_spec(ds)
    torch.manual_seed(0)
    model = get_model('hg', device=dev, num_stacks=1, num_classes=16,
                      fuse_block=True, fuse_upsample=True)
    state = init_state(model, make_optimizer(2.5e-4, [], 0.1, 10))
    step = make_train_step(spec, device_pipeline=True)
    tracing.reset()
    losses = [float(step(state, raw, 0)[1]['loss']) for _ in range(3)]
    counts = launch_counts()
    # per step: 4 merges, 1 stem + 4 encoder pools (their backward gives a
    # tie's gradient to the first maximum), 1 render
    assert counts == dict(fused_bottleneck_image=0, fused_bottleneck_chunked=0,
                          upsample2x_add=12, decode_peaks=0,
                          upsample2x_add_bwd=12, maxpool2x2_fwd=15,
                          maxpool2x2_bwd=0, maxpool2x2_bwd_first=15, render_gaussian=3)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize('backend', ['gloo', 'nccl'])
def test_pipeline_step_on_two_ranks_launches_the_kernels(dev, tmp_path, backend):
    """Two pipeline ranks (tests/torch_port_pipeline_ranks.py --card):
    over gloo both on this card, a CUDA tensor handed from stage 0 to
    stage 1 through host memory; over NCCL one on each of two cards (it
    skips with fewer), handed device to device. It arrives equal, on the
    receiver's card. Then one pipelined train step of a 2-stack bf16 model
    (a stack a stage, 2 microbatches) with the kernels: per microbatch
    stage 0 runs the stem's pool and its stack's 4 pools and 4 merges,
    stage 1 its stack's, each forward and backward, and each stage renders
    the targets once."""
    if backend == 'nccl' and torch.cuda.device_count() < 2:
        pytest.skip('the NCCL pipeline needs two CUDA devices')
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), WORLD_SIZE='2', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, str(repo / 'tests' / 'torch_port_pipeline_ranks.py'),
                               '--card', backend, str(tmp_path)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = [proc.communicate(timeout=600)[0].decode(errors='replace') for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), logs
    got = [json.loads((tmp_path / f'card{r}.json').read_text()) for r in range(2)]
    assert [g['stage'] for g in got] == [0, 1] and all(g['handoff'] for g in got)
    assert [g['device'] for g in got] == (['cuda:0', 'cuda:0'] if backend == 'gloo'
                                          else ['cuda:0', 'cuda:1'])
    assert got[0]['loss'] == got[1]['loss'] and np.isfinite(got[0]['loss'])
    M = 2
    for g, pools in zip(got, (M * 5, M * 4)):
        assert g['launches'] == dict(fused_bottleneck_image=0, fused_bottleneck_chunked=0,
                                     upsample2x_add=M * 4, decode_peaks=0,
                                     upsample2x_add_bwd=M * 4, maxpool2x2_fwd=pools,
                                     maxpool2x2_bwd=0, maxpool2x2_bwd_first=pools,
                                     render_gaussian=1), g


def test_overlapped_step_stages_on_a_side_stream(dev):
    """The overlapped step (`make_overlapped_train_step`) stages batch N+1 on
    its side stream while it steps batch N: read on the current stream with
    no synchronisation, each staged batch equals the sequential
    augmentation of that batch (the same step generator), so the event
    orders it; the losses equal the sequential step's (the step on the card
    is deterministic), and the staging's render runs on the side stream
    (one render a batch, the drain's none)."""
    import copy
    from hourglass_pose_estimation_torch.runner.train_state import (
        STAGED_KEYS, make_overlapped_train_step, make_stage_fn)
    ds = Synthetic(True, num_samples=12, inp_res=64, out_res=16, sigma=1, scale_factor=0.25,
                   rot_factor=30)
    spec = make_spec(ds)
    raws = [ds.canvas_batch(range(i * 4, i * 4 + 4), canvas=64) for i in range(3)]
    torch.manual_seed(0)
    model = get_model('hg', device=dev, num_stacks=1, num_classes=16, fuse_block=True,
                      fuse_upsample=True)
    tx = make_optimizer(2.5e-4, [], 0.1, 10)
    seq_state, state = init_state(copy.deepcopy(model), tx), init_state(model, tx)
    seq, stage = make_train_step(spec), make_stage_fn(spec, device=dev)
    seq_losses = [float(seq(seq_state, raw, 5)[1]['loss']) for raw in raws]
    ostep, drain = make_overlapped_train_step(spec), make_train_step(spec, device_pipeline=False)
    tracing.reset()
    staged, losses = stage(raws[0], 5, 0), []
    for i, raw in enumerate(raws[1:], 1):
        state, staged, m = ostep(state, staged, raw, 5)
        losses.append(float(m['loss']))
        ref = stage(raw, 5, i)
        assert all(torch.equal(staged[k], ref[k]) for k in STAGED_KEYS), i
    state, m = drain(state, staged, 5)
    losses.append(float(m['loss']))
    assert state.step == 3
    assert losses == seq_losses, (losses, seq_losses)
    # renders: the prime, 2 overlapped stagings and the 2 re-stagings above
    assert launched(render_gaussian) == 5


@pytest.mark.parametrize('backend', ['gloo', 'nccl'])
def test_tensor_parallel_step_on_two_ranks_launches_the_kernels(dev, tmp_path, backend):
    """Two tensor-parallel ranks (data 1 x model 2,
    tests/torch_port_tp_ranks.py --card): over gloo both on this card (every
    collective through host memory), over NCCL one on each of two cards (it
    skips with fewer). One train step of a 1-stack bf16 model with the
    kernels: the loss is the same on both ranks, leaves are sharded, the
    model axis's collectives ran, and every rank, which sees the full
    activations, launches the one-process step's kernels: 4 merges, 1 stem
    and 4 encoder pools, each forward and backward, and 1 render."""
    if backend == 'nccl' and torch.cuda.device_count() < 2:
        pytest.skip('the NCCL layout needs two CUDA devices')
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), WORLD_SIZE='2', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, str(repo / 'tests' / 'torch_port_tp_ranks.py'),
                               '--card', backend, str(tmp_path)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = [proc.communicate(timeout=600)[0].decode(errors='replace') for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), logs
    got = [json.loads((tmp_path / f'card{r}.json').read_text()) for r in range(2)]
    assert [g['model_rank'] for g in got] == [0, 1]
    assert [g['device'] for g in got] == (['cuda:0', 'cuda:0'] if backend == 'gloo'
                                          else ['cuda:0', 'cuda:1'])
    assert got[0]['loss'] == got[1]['loss'] and np.isfinite(got[0]['loss'])
    for g in got:
        assert g['sharded_leaves'] > 0 and g['collectives'] > 0
        assert g['launches'] == dict(fused_bottleneck_image=0, fused_bottleneck_chunked=0,
                                     upsample2x_add=4, decode_peaks=0, upsample2x_add_bwd=4,
                                     maxpool2x2_fwd=5, maxpool2x2_bwd=0,
                                     maxpool2x2_bwd_first=5, render_gaussian=1), g


def test_trainer_stages_batches_on_a_side_stream(dev, tmp_path):
    """The Trainer's producer copies pinned canvases on its copy stream; the
    consumer's stream waits for that copy, and the tensors equal the host
    batch. Then one epoch of a 1-stack model runs on the card with the
    kernels, validation and a snapshot."""
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.runner import Trainer
    cfg = load_config(raw={
        'DATASET': {'name': 'synthetic', 'inp_res': 64, 'out_res': 16, 'num_samples': 8},
        'MODEL': {'num_stacks': 1},
        'TRAIN': {'epochs': 1, 'train_batch': 4, 'val_batch': 3, 'learning_rate': 2.5e-5},
        'COMMON': {'checkpoint_dir': str(tmp_path), 'snapshot': 1}})
    t = Trainer(cfg, verbose=False, device=dev)
    raw = t.train_ds.canvas_batch(np.arange(4), canvas=t.canvas, crop_aware=t.crop_aware)
    staged = t._stage(raw)
    assert staged[1] is not None and staged[0]['canvas'].device.type == 'cuda'
    batch = t._take(staged)
    for k, v in raw.items():
        assert np.array_equal(batch[k].cpu().numpy(), v), k
    tracing.reset()
    t.train()
    h = t.history[0]
    assert np.isfinite([h['train_loss'], h['val_loss']]).all()
    assert launched(fused_bottleneck_chunked) + launched(fused_bottleneck_image) > 0
    assert (tmp_path / 'ckpts' / 'checkpoint_1').is_file()


def test_predict_keypoints_on_the_card_matches_the_plain_path(dev):
    """The Evaluator's flip-test keypoints on the card, an f32 1-stack model
    (standard blocks; the upsample and pool kernels and the decode kernel
    on), against the same model with the kernels off on the card: those
    kernels are exact, so the keypoints are equal. Launches per val batch
    of 3: two forwards' 8 upsample and 10 pool, and 1 decode."""
    from hourglass_pose_estimation_torch.config import load_config
    from hourglass_pose_estimation_torch.runner import Evaluator, TrainState
    cfg = load_config(raw={
        'DATASET': {'name': 'synthetic', 'inp_res': 64, 'out_res': 16, 'num_samples': 7},
        'MODEL': {'num_stacks': 1}, 'TRAIN': {'val_batch': 3, 'precision': 'f32'},
        'EVAL': {'flip_test': True}})
    ev = Evaluator(cfg, verbose=False, device=dev)
    torch.manual_seed(0)
    states = {}
    for on in (True, False):
        model = get_model('hg', device=dev, num_stacks=1, num_classes=16, dtype=torch.float32,
                          fuse_block=on, fuse_upsample=on)
        if states:
            model.load_state_dict(states[True].model.state_dict())
        states[on] = TrainState(model=model, tx=None, optimizer=None)
    tracing.reset()
    got = ev.predict_keypoints(states[True])
    counts = launch_counts()
    assert counts == dict(fused_bottleneck_image=0, fused_bottleneck_chunked=0,
                          upsample2x_add=8 * 3, decode_peaks=3, upsample2x_add_bwd=0,
                          maxpool2x2_fwd=10 * 3, maxpool2x2_bwd=0, maxpool2x2_bwd_first=0,
                          render_gaussian=0)
    ref = ev.predict_keypoints(states[False])
    assert got.shape == (7, 16, 2) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_dark_decode_on_the_card_equals_the_cpu(dev):
    """DARK on the card with TF32 on against the CPU on the same flat
    heatmaps (those of random weights, where peaks' Hessians are nearly
    singular): the blur's sums in the same order and the log taken in f64
    give the same bits, where an f32 log's last bit would move the Newton
    step."""
    from hourglass_pose_estimation_torch.ops.decode import decode_dark
    gen = torch.Generator().manual_seed(5)
    hm = 0.05 * torch.rand(32, 64, 64, 16, generator=gen)
    center = torch.rand(32, 2, generator=gen) * 200 + 28
    scale = torch.rand(32, generator=gen) + 0.8
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = decode_dark(hm.to(dev), center.to(dev), scale.to(dev), zero_based=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    ref = decode_dark(hm, center, scale, zero_based=True)
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])


@pytest.mark.parametrize('size', [(8, 8, 16, 16), (7, 5, 13, 9), (16, 16, 8, 8), (2, 2, 64, 64)])
def test_align_corners_resize_on_the_card_matches_the_cpu(dev, size):
    """The MSPN decoder's resize (two f32 products, TF32 off) on the card
    against the CPU: f32 within 1e-6 of the largest value, its gradient too,
    and bf16 within one bf16 step."""
    from hourglass_pose_estimation_torch.ops.resize import resize_bilinear_align_corners
    H, W, h, w = size
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, H, W, 256, generator=gen)
    g = torch.randn(4, h, w, 256, generator=gen)
    outs, grads = [], []
    for d in ('cpu', dev):
        xd = x.to(d).clone().requires_grad_()
        y = resize_bilinear_align_corners(xd, (h, w))
        (y * g.to(d)).sum().backward()
        outs.append(y.detach().cpu())
        grads.append(xd.grad.cpu())
    assert (outs[1] - outs[0]).abs().max() <= 1e-6 * outs[0].abs().max()
    assert (grads[1] - grads[0]).abs().max() <= 1e-6 * grads[0].abs().max()
    yb = [resize_bilinear_align_corners(x.to(d, torch.bfloat16), (h, w)).cpu().float()
          for d in ('cpu', dev)]
    assert bool(((yb[1] - yb[0]).abs() <= 2 ** -7 * yb[0].abs()).all())


def test_mspn_on_the_card_matches_the_cpu(dev):
    """A 2-stage MSPN (decoder width 64) at 64^2 in f32 on the card against
    the CPU, TF32 off: the train and eval forwards' heads within 1e-4
    relative L2 each, the train-mode running statistics too; in bf16 the
    card's heads against the CPU's bf16 and f32 forwards. No port kernel
    runs in the model (its stem pool is 3x3/2, its upsample bilinear), and
    the stem pool's backward gives each tie to the first maximum on the
    card too. The weights: each residual branch's last BN scale (`cbr3`)
    at 0.05 and running statistics of one batch (momentum 0). With scale 1
    a train-mode MSPN at init is chaotic: f32 rounding grows ~1.2x a block
    (on the CPU, f32 against f64: 1.3e-2 at stage 2's heads), too much to
    compare; at 0.05 f32 against f64 reads 6e-6 and the CPU's bf16
    against its f32 8.7e-2."""
    import torch.nn.functional as F
    from hourglass_pose_estimation_torch.models import MSPN
    from hourglass_pose_estimation_torch.models.norm import BatchNorm
    torch.manual_seed(0)
    kw = dict(num_stacks=2, num_classes=16, out_res=16, up_channel_num=64)
    cpu = get_model('mspn', device='cpu', dtype=torch.float32, **kw)
    x = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    bns = [(n, m) for n, m in cpu.named_modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for n, m in bns:
            m.momentum = 0.0
            if n.endswith('cbr3.bn'):
                m.weight.mul_(0.05)
        cpu(x, train=True)
    for _, m in bns:
        m.momentum = 0.9
    card = get_model('mspn', device=dev, dtype=torch.float32, **kw)
    card.load_state_dict(cpu.state_dict())
    tracing.reset()
    for train in (True, False):
        with torch.no_grad():
            ref, got = cpu(x, train=train), card(x.to(dev), train=train).cpu()
        assert got.shape == ref.shape == (8, 4, 16, 16, 16)
        for h in range(8):
            assert _rel(got[h], ref[h]) <= 1e-4, (train, h, _rel(got[h], ref[h]))
    for a, b in zip(cpu.state_dict().values(), card.state_dict().values()):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(a.abs().max()) + 1e-7
    assert not any(launch_counts().values())
    bf16 = {}
    for d in ('cpu', dev):
        m = get_model('mspn', device=d, **kw)
        m.load_state_dict(cpu.state_dict())
        assert isinstance(m, MSPN) and m.compute_dtype == torch.bfloat16
        with torch.no_grad():
            bf16[d] = m(x.to(d)).cpu()
    worst = [max(_rel(bf16[dev][h], r[h]) for h in range(8)) for r in (bf16['cpu'], ref)]
    assert worst[0] <= 0.35 and worst[1] <= 0.35, worst
    ties = torch.randint(0, 3, (2, 64, 33, 34), generator=torch.Generator().manual_seed(2))
    g = torch.randint(-8, 9, (2, 64, 17, 17), generator=torch.Generator().manual_seed(3))
    grads = []
    for d in ('cpu', dev):
        xt = ties.to(d, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        xt.requires_grad_()
        F.max_pool2d(xt, 3, 2, 1).backward(g.to(d, torch.bfloat16))
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_file_canvases_on_this_machine_match_the_numpy_warp(dev, tmp_path, monkeypatch):
    """The crop canvases of JPEG files through this machine's cv2
    (warpAffine; the native loader forced off) against the port's numpy
    `warp_region` on the same decoded pixels: within 1 level (the rounding
    of the taps' weights differs), on at most 1e-4 of the values."""
    import cv2
    from hourglass_pose_estimation_torch.data import fabricate, get_dataset, native
    from hourglass_pose_estimation_torch.data.common import warp_region
    monkeypatch.setattr(native, 'load_region_batch', lambda *a, **k: None)
    img, ann, _ = fabricate.mpii_tree(str(tmp_path), np.random.RandomState(0), n_train=2,
                                      n_valid=4, image_size=(640, 360), scales=(0.6, 1.2),
                                      n_small=2)
    ds = get_dataset('mpii', False, image_path=img, annotation_path=ann, inp_res=256, out_res=64)
    idx = [0, 1, 2, 3]
    got = ds.canvas_batch(idx, canvas=256, crop_aware=True)
    assert ds.slot_paths == {'native': 0, 'cv2': 4, 'memory': 0}
    sides = ds._region_sides(idx)
    for k, i in enumerate(idx):
        src = cv2.imread(ds.records.image_paths[i], cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        ox, oy = got['canvas_offset'][k]
        ref = warp_region(src, float(got['canvas_scale'][k]), ox, oy, 256)
        diff = np.abs(got['canvas'][k].astype(int) - ref)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (k, diff.max(), (diff > 0).mean())
        assert got['width'][k] == src.shape[1]
    assert float(got['canvas_scale'][0]) == 1.0 and float(sides[0]) < 256


def test_prepare_host_batch_on_the_card_matches_the_cpu(dev):
    """Host crops normalised and rendered on the card (the render kernel,
    one launch) against the CPU: the image within 1e-6 (PyTorch's CUDA
    division by a scalar multiplies by its reciprocal, the CPU divides: 1
    ulp apart before the division by std), the targets within 1e-6 (expf
    against exp) and the weights equal."""
    from hourglass_pose_estimation_torch.data import prepare_host_batch
    gen = torch.Generator().manual_seed(0)
    batch = {'image': torch.randint(0, 256, (8, 256, 256, 3), generator=gen, dtype=torch.uint8),
             'joints': torch.rand(8, 16, 2, generator=gen) * 300 - 20,
             'vis': (torch.rand(8, 16, generator=gen) > 0.2).float()}
    spec = make_spec(Synthetic(False, num_samples=1, inp_res=256, out_res=64))
    before = launched(render_gaussian)
    got = prepare_host_batch({k: v.to(dev) for k, v in batch.items()}, spec)
    assert launched(render_gaussian) == before + 1
    ref = prepare_host_batch(batch, spec)
    assert launched(render_gaussian) == before + 1
    assert float((got['image'].cpu() - ref['image']).abs().max()) <= 1e-6
    assert torch.equal(got['target_weight'].cpu(), ref['target_weight'])
    assert float((got['target'].cpu() - ref['target']).abs().max()) <= 1e-6


def _cuda_op_cases(dev):
    """Valid inputs on the card for each of the nine `hpe::` ops."""
    torch.manual_seed(0)
    # detached: a folded vector may be the block's own bias parameter
    prm = [t.detach() for t in Bottleneck(256, 128).to(dev).fused_params()]
    xb = torch.randn(2, 16, 16, 256, device=dev).to(torch.bfloat16)
    t = lambda *s: torch.randn(*s, device=dev)
    mu = torch.randint(-3, 20, (2, 16, 2), device=dev, dtype=torch.int32)
    return {
        'fused_bottleneck_chunked': (xb, *prm),
        'fused_bottleneck_image': (xb, *prm),
        'upsample2x_add': (t(2, 4, 4, 64), t(2, 8, 8, 64)),
        'upsample2x_add_bwd': (t(2, 8, 8, 64),),
        'maxpool2x2_fwd': (t(2, 8, 8, 64),),
        'maxpool2x2_bwd': (t(2, 8, 8, 64), t(2, 4, 4, 64)),
        'maxpool2x2_bwd_first': (t(2, 8, 8, 64), t(2, 4, 4, 64)),
        'render_gaussian': (mu, torch.ones(2, 16, device=dev), 16, 12, 1.0),
        'decode_peaks': (t(2, 8, 8, 16),),
    }


@pytest.mark.parametrize('name', sorted(w.__name__ for w in KERNEL_WRAPPERS))
def test_kernel_op_on_the_card_agrees_with_its_fake(dev, name):
    """Each `hpe::` op's CUDA kernel (the launch) against its schema and its
    fake: output shapes, dtypes and strides, as `torch.export` relies on."""
    torch.library.opcheck(getattr(torch.ops.hpe, name).default, _cuda_op_cases(dev)[name])


def test_exported_flagship_program_keeps_the_kernels(dev, tmp_path):
    """The flagship serving function (8 stacks, folded BN, bf16 weights,
    uint8 frames, the quarter decode) exported and loaded back: the same
    bits as make_inference_fn, and per call exactly the launches of the
    in-process function (65 fused bottleneck, 32 upsample, 33 pool, 1
    decode)."""
    from hourglass_pose_estimation_torch.data import get_meanstd
    from hourglass_pose_estimation_torch.export import export_program, load_program
    from hourglass_pose_estimation_torch.ops.hopper import bottleneck as bk
    torch.manual_seed(0)
    model = get_model('hg', device='cpu', num_stacks=8, num_classes=16,
                      fuse_block=True, fuse_upsample=True)
    kw = dict(decode='quarter', fold_bn=True, weights_dtype=torch.bfloat16,
              preprocess=get_meanstd('mpii'), input_res=256)
    frames = np.random.RandomState(1).randint(0, 256, (4, 256, 256, 3)).astype(np.uint8)
    path = export_program(model, None, frames.shape, str(tmp_path / 'model.pt2'), **kw)
    fn, program = make_inference_fn(model, None, **kw), load_program(path)
    ref = fn(frames)
    program(frames)
    tracing.reset()
    got = program(frames)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {f'fused_bottleneck_{bk.DEFAULT_IMPL}': 65, 'upsample2x_add': 32,
            'maxpool2x2_fwd': 33, 'decode_peaks': 1}
    assert launches == {k: want.get(k, 0) for k in launches}
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
