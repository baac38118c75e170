"""The port's HRNet against the benchmark's plain reference
(`hpe_bench/reference/hrnet.py`), on the CPU in f32 at a tiny size: width
8 (branches of 8, 16, 32 and 64), one BasicBlock a branch, 64^2 in, 16^2
out, batch 4. The JAX package has no HRNet, so the reference is the plain
f32 PyTorch one that the benchmark's `correct` is decided against.

Checked: the eval and train forwards and the step-1 gradients on seeded
weights (`hpe_bench/synth.weights`, loaded by name into both); W48's
parameter and BatchNorm counts on the meta device against its
configuration file; `MODEL.arch=hrnet` through `model_from_config` from
`configs/train_mpii_hrnet48.yaml`'s keys, the factory's refusals, and one
train step through `runner.make_train_step` that records a
`train.exchange` span a module; the configuration file stating each
width once, under `model`, and its `bn_scale_of` naming each BasicBlock's
last BatchNorm and nothing else."""

import json
from pathlib import Path

import pytest
import torch

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch.data import Synthetic, make_spec
from hourglass_pose_estimation_torch.loss import heatmap_mse_loss
from hourglass_pose_estimation_torch.models import get_model, model_from_config
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.runner import train_state as tts
from hourglass_pose_estimation_torch.utils import tracing
from hpe_bench import harness, program
from hpe_bench.reference import pipeline
from hpe_bench.reference import train as reference

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CFG = harness.read_json(harness.BENCH_DIR / 'configs' / 'hrnet48-mpii.json')
TINY = dict(width=8, branch_blocks=1, inp_res=64, out_res=16, compute_dtype='float32')
# modules of stages 2-4, one exchange each
MODULES = sum(CFG['model']['stage_modules'])
# both in f32; the port's conv adds its bias after the product and its
# BatchNorm takes the one-pass variance, the reference's the two-pass one.
# Forward: read 1.1e-6 (eval) and 1.4e-5 (train) of the largest output.
TOL_EVAL, TOL_TRAIN = 1e-5, 1e-4
# step-1 gradients, each leaf's difference over the larger of its norm and
# the median leaf's: the one-pass variance of activations whose mean far
# exceeds their spread (residual sums) cancels in f32, and the 2x2
# branch's statistics are over 16 values a channel; read: median 1e-4,
# worst 3.6e-3 (a stage-4 conv)
TOL_GRAD_MEDIAN, TOL_GRAD_WORST = 1e-3, 2e-2


def tiny_cfg():
    cfg = json.loads(json.dumps(CFG))
    for k, v in TINY.items():
        cfg[k] = v
        if k in cfg['model']:
            cfg['model'][k] = v
    return cfg


@pytest.fixture(scope='module')
def pair():
    """(the port's HRNet, the reference) at the tiny size, on the same
    seeded weights."""
    cfg = tiny_cfg()
    model, weights = program.build_model(cfg, 7, 'cpu')
    ref = reference.build(cfg, 'cpu')
    ref.load_state_dict(weights, strict=True)
    return model, ref


def _inputs():
    g = torch.Generator().manual_seed(3)
    return (torch.randn(4, 64, 64, 3, generator=g), torch.rand(4, 16, 16, 16, generator=g),
            torch.ones(4, 16))


@pytest.mark.parametrize('train', [False, True])
def test_forward_matches_the_reference(pair, train):
    model, ref = pair
    x, _, _ = _inputs()
    with torch.no_grad():
        a, b = model(x, train=train), ref(x, train=train)
    assert a.shape == b.shape == (1, 4, 16, 16, 16) and a.dtype == torch.float32
    assert float((a - b).abs().max() / b.abs().max()) <= (TOL_TRAIN if train else TOL_EVAL)


def test_step_one_gradients_match_the_reference(pair):
    model, ref = pair
    x, target, w = _inputs()
    ga = torch.autograd.grad(heatmap_mse_loss(model(x, train=True), target, w),
                             list(model.parameters()))
    gb = torch.autograd.grad(pipeline.loss_fn(ref(x, train=True), target, w),
                             list(ref.parameters()))
    norms = sorted(float(b.norm()) for b in gb)
    med = norms[len(norms) // 2]
    gaps = sorted(float((a - b).norm()) / max(float(b.norm()), med) for a, b in zip(ga, gb))
    assert gaps[len(gaps) // 2] <= TOL_GRAD_MEDIAN and gaps[-1] <= TOL_GRAD_WORST, gaps[-5:]


def test_w48_counts_match_its_configuration_file():
    with torch.device('meta'):
        model = get_model('hrnet', device='meta', num_stacks=1, num_classes=16,
                          **CFG['model'])
        ref = reference.build(CFG, 'meta')
    assert sum(p.numel() for p in model.parameters()) == CFG['parameters']
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == CFG['batchnorms']
    assert [n for n, _ in model.named_parameters()] == [n for n, _ in ref.named_parameters()]


def test_the_configuration_states_each_width_once():
    """The program and the reference both build from `model`; no key of
    it is repeated at the top level, where the two could drift apart."""
    assert CFG['model'] == dict(width=48, branch_blocks=4, stage_modules=[1, 4, 3])
    assert not set(CFG['model']) & (set(CFG) - {'model'})


def test_bn_scale_of_names_each_basic_blocks_last_batchnorm():
    """`synth.weights` scales the BatchNorm scales whose names end in a
    `bn_scale_of` key: in W48 those are exactly the 4 x (2 + 3 x 4 + 4 x 3)
    = 104 BasicBlocks' second BatchNorms."""
    with torch.device('meta'):
        model = get_model('hrnet', device='meta', num_stacks=1, num_classes=16,
                          **CFG['model'])
    names = [n for n, _ in model.named_parameters()]
    (end, factor), = CFG['bn_scale_of'].items()
    scaled = [n for n in names if n.endswith(end)]
    blocks = [n for n, m in model.named_modules() if type(m).__name__ == 'BasicBlock']
    assert sorted(scaled) == sorted(f'{b}.cb2.bn.weight' for b in blocks)
    assert len(blocks) == 4 * (2 + 3 * 4 + 4 * 3) and 0 < factor < 1


def test_config_builds_hrnet_and_the_factory_refuses_what_it_lacks():
    cfg = tconfig.load_config(str(REPO / 'configs' / 'train_mpii_hrnet48.yaml'),
                              overrides=['MODEL.width=8'])
    assert (cfg.model.arch, cfg.model.num_stacks, cfg.model.fuse_block) == ('hrnet', 1, False)
    model = model_from_config(cfg.model, num_classes=16, out_res=16, device='cpu',
                              dtype=torch.float32)
    assert model.width == 8 and model.stage_modules == (1, 4, 3)
    assert model.head.weight.is_contiguous(memory_format=torch.channels_last)
    kw = dict(device='cpu', num_stacks=1, num_classes=16, width=8)
    for bad in (dict(fuse_block=True), dict(fuse_upsample=True), dict(remat=True),
                dict(bn_stat_samples=2), dict(mobile=True), dict(skip_mode='concat'),
                dict(num_stacks=2), dict(up_channel_num=128)):
        with pytest.raises(ValueError):
            get_model('hrnet', **{**kw, **bad})


def test_train_step_records_an_exchange_span_a_module():
    ds = Synthetic(True, num_samples=2, inp_res=64, out_res=16, sigma=1)
    raw, spec = ds.canvas_batch(range(2), canvas=64), make_spec(ds)
    torch.manual_seed(0)
    model = get_model('hrnet', device='cpu', num_stacks=1, num_classes=16, width=8,
                      branch_blocks=1, dtype=torch.float32)
    state = tts.init_state(model, tts.make_optimizer(2.5e-3, [], 0.1, 4))
    step = tts.make_train_step(spec)
    tracing.reset()
    tracing.enable()
    try:
        state, m = step(state, raw, 0)
    finally:
        tracing.disable()
    spans = tracing.spans()
    tracing.reset()
    assert torch.isfinite(m['loss'])
    forward = next(s for s in spans if s['name'] == 'train.forward')
    ex = [s for s in spans if s['name'] == 'train.exchange']
    assert len(ex) == MODULES and all(s['parent'] == forward['id'] and s['step'] == 0
                                      for s in ex)

