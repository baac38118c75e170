"""The port's MSPN against the JAX package's, on the CPU in f32 at 64^2 ->
16^2 and decoder width 64 (16 joints): the align-corners resize and its
gradient, the parameter counts at full width, the eval forward (every
head), the train step, the stem pool's tie gradient, the serving function
with folded BN and the quarter decode, the Estimator, the config path with
the factory's refusals, and a short Trainer run with the evaluate_only CLI.

Weights: the port's seeded init with random BatchNorm affines, carried to
flax under its own names by `weights.to_jax_variables` (which
`load_jax_variables` reads back strictly), and running statistics from one
train-mode flax pass."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import flax.linen as nn
import optax

from hourglass_pose_estimation_tpu import config as jconfig
from hourglass_pose_estimation_tpu.data import Synthetic as JaxSynthetic
from hourglass_pose_estimation_tpu.data import make_spec as jax_make_spec
from hourglass_pose_estimation_tpu.data.pipeline import sample_augmentations as jax_sample
from hourglass_pose_estimation_tpu.export import make_inference_fn as jax_inference_fn
from hourglass_pose_estimation_tpu.loss import heatmap_mse_loss as jax_loss
from hourglass_pose_estimation_tpu.data.pipeline import augment_batch as jax_augment
from hourglass_pose_estimation_tpu.models import MSPN as JaxMSPN
from hourglass_pose_estimation_tpu.ops.resize import (
    resize_bilinear_align_corners as jax_resize)
from hourglass_pose_estimation_tpu.runner import train_state as jts
from hourglass_pose_estimation_tpu.runner.estimator import Estimator as JaxEstimator

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch import train_and_evaluate
from hourglass_pose_estimation_torch.data import Synthetic, make_spec
from hourglass_pose_estimation_torch.export import make_inference_fn
from hourglass_pose_estimation_torch.models import MSPN, get_model, model_from_config
from hourglass_pose_estimation_torch.models.modules import Conv
from hourglass_pose_estimation_torch.models.mspn import ConvBN
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.ops.resize import resize_bilinear_align_corners
from hourglass_pose_estimation_torch.runner import Estimator, Trainer
from hourglass_pose_estimation_torch.runner import train_state as tts
from hourglass_pose_estimation_torch.weights import load_jax_variables, to_jax_variables

torch.set_num_threads(1)

KW = dict(num_classes=16, out_res=16, up_channel_num=64)
# the reference torch MSPN's counts (16 joints, decoder width 256, out_res
# 64, non-mobile), as tests/test_mspn.py holds the JAX model to them
REFERENCE_COUNTS = {1: 25_132_480, 2: 56_848_576}
MEANSTD = ((0.406822, 0.444257, 0.466048), (0.228944, 0.232618, 0.236498))
# the resize: both take the same f32 products; summation order differs
# (read 4.8e-7 relative to the largest value), held at 1e-6
TOL_RESIZE = 1e-6
# the eval forward, every head, relative L2 per head: read at most 2.8e-6
# (2-stage) over 8 heads, held at 2e-5
TOL_EVAL = 2e-5
# the train step, f32 through the device pipeline with the JAX draws: held
# at about 4x the readings that test_train_step_matches_jax states
TOL_LOSS = 2e-6
TOL_GRAD = 2e-3
TOL_GRAD_LEAF = 1.5e-2
TOL_BIAS_GRAD = 3e-6
TOL_STATS = 2e-5


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream (conftest's is shared by the files an
    xdist worker runs)."""
    return np.random.RandomState(0)


def _randomize_bn_(model, seed, residual_scale=1.0):
    """BN scales 1 +- 0.1 (times `residual_scale` on each residual branch's
    last BN, `cbr3`) and biases +- 0.1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                k = residual_scale if name.endswith('cbr3.bn') else 1.0
                m.weight.copy_(k * (1 + 0.1 * torch.randn(n, generator=gen)))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))


@functools.lru_cache(maxsize=None)
def _weights(stacks, mobile=False, zero_init_residual=False, seed=0, residual_scale=1.0):
    """(flax MSPN in f32, its variables after one train-mode pass on a
    seeded batch): the port's seeded init with random BN affines."""
    torch.manual_seed(seed)
    model = get_model('mspn', device='cpu', num_stacks=stacks, mobile=mobile,
                      zero_init_residual=zero_init_residual, dtype=torch.float32, **KW)
    _randomize_bn_(model, seed + 1, residual_scale)
    variables = to_jax_variables(model)
    jmodel = JaxMSPN(num_stacks=stacks, mobile=mobile, zero_init_residual=zero_init_residual,
                     dtype=jnp.float32, **KW)
    x = np.random.RandomState(seed + 2).normal(size=(4, 64, 64, 3)).astype(np.float32)
    _, mut = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=['batch_stats'])
    variables['batch_stats'] = jax.tree.map(np.asarray, mut['batch_stats'])
    return jmodel, variables


def _port(variables, stacks, dtype=torch.float32, **kw):
    model = get_model('mspn', device='cpu', num_stacks=stacks, dtype=dtype, **{**KW, **kw})
    return load_jax_variables(model, variables)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize('size', [(8, 8, 16, 16), (16, 16, 64, 64), (7, 5, 13, 9),
                                  (16, 16, 8, 8), (9, 11, 4, 3), (6, 6, 6, 6)])
def test_resize_align_corners_matches_jax(rng, size):
    """Upsizing, downsizing, odd sizes and the identity; the gradient
    against `jax.grad` of the same weighted sum."""
    H, W, h, w = size
    x = rng.normal(size=(2, H, W, 5)).astype(np.float32)
    g = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), (h, w)))
    xt = torch.from_numpy(x).requires_grad_()
    got = resize_bilinear_align_corners(xt, (h, w))
    assert got.shape == (2, h, w, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=TOL_RESIZE * np.abs(ref).max())
    (got * torch.from_numpy(g)).sum().backward()
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jax_resize(v, (h, w)) * g))(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=0, atol=TOL_RESIZE * np.abs(jg).max())
    # bf16 in, bf16 out: computed in f32 and rounded once, as the JAX
    # function; an f32 sum whose last bits differ lands one bf16 step away
    # where it lies on a rounding boundary (read 1 of 2560 elements)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = resize_bilinear_align_corners(xb, (h, w))
    rb = jax_resize(jnp.asarray(x, jnp.bfloat16), (h, w))
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(rb, np.float32), rtol=2 ** -7,
                               atol=0)
    if (H, W) == (h, w):
        assert resize_bilinear_align_corners(xt, (h, w)) is xt


@pytest.mark.parametrize('stacks', sorted(REFERENCE_COUNTS))
def test_param_counts_match_reference(stacks):
    """Full width, built without a forward."""
    model = MSPN(num_stacks=stacks, num_classes=16, out_res=64, up_channel_num=256)
    assert sum(p.numel() for p in model.parameters()) == REFERENCE_COUNTS[stacks]


@pytest.mark.parametrize('stacks,mobile,zero_init_residual', [
    (2, False, False), (1, True, False), (1, False, True)])
def test_eval_forward_matches_flax(rng, stacks, mobile, zero_init_residual):
    """Every head of the stacked output [S*4, B, 16, 16, 16]; at 2 stages
    the cross-stage skips and the cross conv run."""
    jmodel, variables = _weights(stacks, mobile, zero_init_residual)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = _port(variables, stacks, mobile=mobile, zero_init_residual=zero_init_residual)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (4 * stacks, 2, 16, 16, 16) and got.dtype == np.float32
    for h in range(4 * stacks):
        assert _rel(got[h], ref[h]) <= TOL_EVAL, (h, _rel(got[h], ref[h]))


def test_init_follows_the_jax_initializers():
    """Kaiming fan-out normal on every conv (std sqrt(2 / (out * k * k)),
    grouped and depthwise too), zero conv biases, BN scale 1 and bias 0,
    and zero `cbr3` scales under zero_init_residual."""
    torch.manual_seed(3)
    model = MSPN(num_stacks=1, mobile=True, zero_init_residual=True, **KW)
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    for m in convs:
        assert float(m.bias.detach().abs().max()) == 0.0
        if m.weight.numel() >= 16384:
            want = (2.0 / (m.out_channels * m.kernel_size[0] * m.kernel_size[1])) ** 0.5
            assert abs(float(m.weight.detach().std()) / want - 1) < 0.05
    assert any(m.groups > 1 for m in convs)
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            assert float(m.bias.detach().abs().max()) == 0.0
            scale = 0.0 if name.endswith('cbr3.bn') else 1.0
            assert bool((m.weight == scale).all()), name
    # only the first block of each trunk layer is mobile
    trunk = model.stage0.downsample
    assert trunk.layer2_block0.cbr2.conv.groups == 128
    assert trunk.layer2_block1.cbr2.conv.groups == 1


def test_stem_pool_gradient_matches_jax_max_pool(rng):
    """The stem's 3x3 stride-2 pool with padding 1 (`F.max_pool2d`) gives
    a window's gradient to its first maximum, as `nn.max_pool` does, ties
    planted in most windows (overlapping windows add up). The output
    gradient holds small integers, so every sum is exact in bf16 too and
    the two must be equal in both types."""
    x = rng.randint(0, 3, size=(2, 9, 10, 4)).astype(np.float32)
    g = rng.randint(-8, 9, size=(2, 5, 5, 4)).astype(np.float32)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jg = jax.grad(lambda v: jnp.sum(nn.max_pool(
            v, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))) * g.astype(jdt)))(
                jnp.asarray(x, jdt))
        xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = F.max_pool2d(xt, 3, 2, 1)
        y.backward(torch.from_numpy(g).to(dtype).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(xt.grad.float().permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jg, np.float32))


@pytest.fixture(scope='module')
def data():
    kw = dict(num_samples=8, inp_res=64, out_res=16, sigma=1, scale_factor=0.25, rot_factor=30)
    ds, jds = Synthetic(True, **kw), JaxSynthetic(True, **kw)
    return ds.canvas_batch([0, 1, 2, 3], canvas=64), make_spec(ds), jax_make_spec(jds)


def test_train_step_matches_jax(data, monkeypatch):
    """One step of a 1-stage MSPN through the device pipeline in f32, the
    JAX draws injected into the port's step, against `make_train_step`:
    the loss and PCK, every gradient leaf against `jax.grad` of the same
    loss on the JAX pipeline's batch, the updated parameters and the BN
    statistics.

    The weights put each residual branch's last BN scale (`cbr3`) at 0.05,
    near where a ResNet starts under zero_init_residual. At scale 1 the
    train-mode gradient is too ill-conditioned to compare: the JAX
    package's own jitted and eager gradients of the same loss read 1.1e-2
    to 2.8e-2 relative L2 apart (the port's f32 against its f64 6e-3),
    as rounding flips ReLU derivatives of elements near 0, and on the
    trunk's 2x2 maps over 4 samples one element carries 1/16 of a BN
    leaf's sum; 128^2 is no better (3.7e-2 f32 against f64). At 0.05 JAX
    against itself reads 1.1e-5. Read against JAX: loss 4.7e-7 apart,
    gradients 5.0e-4 relative L2 over all leaves and at most 3.3e-3 a leaf
    (the port warps its own canvases, 1e-7 from the JAX pipeline's image);
    conv biases, whose gradient before a train-mode BN is rounding noise,
    within 7.4e-7 of the largest gradient element; statistics 4.5e-6 of a
    leaf's largest value. RMSprop's first update is lr * 10 * sign(g) for
    most elements, so an element whose gradient lies at the level of the
    two packages' noise moves either way: the updated parameters are held
    to the JAX optimizer's update of the port's own gradients, within 2
    f32 ulps (the two add lr * u to p in their own order)."""
    raw, spec, jspec = data
    jmodel, variables = _weights(1, residual_scale=0.05)
    lr = (2.5e-3, [], 0.1, 4)
    jstate = jts.TrainState.create(apply_fn=jmodel.apply, params=variables['params'],
                                   batch_stats=variables['batch_stats'],
                                   tx=jts.make_optimizer(*lr))
    state = tts.init_state(_port(variables, 1), tts.make_optimizer(*lr))
    key = jax.random.PRNGKey(7)
    draws = tuple(torch.from_numpy(np.array(d)) for d in jax_sample(
        jax.random.fold_in(key, 0), jnp.asarray(raw['scale']),
        scale_factor=spec.scale_factor, rot_factor=spec.rot_factor, train=True))
    monkeypatch.setattr(tts, 'sample_augmentations', lambda gen, scales, **kw: draws)
    staged = jax_augment(raw, jax.random.fold_in(key, 0), jspec, True)

    def loss_fn(params):
        outs, _ = jmodel.apply({'params': params, 'batch_stats': variables['batch_stats']},
                               staged['image'], train=True, mutable=['batch_stats'])
        return jax_loss(outs, staged['target'], staged['target_weight'])

    jgrads = jax.jit(jax.grad(loss_fn))(variables['params'])
    jnew, jm = jts.make_train_step(jspec, device_pipeline=True)(jstate, raw, key)
    state, m = tts.make_train_step(spec, device_pipeline=True)(state, raw, 7)
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol=TOL_LOSS)
    np.testing.assert_allclose(float(m['acc']), float(jm['acc']), atol=1e-6)
    assert state.step == int(jnew.step) == 1

    flat = lambda tree: {'/'.join(str(getattr(k, 'key', k)) for k in p): np.asarray(v)
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    jg = flat(jgrads)
    names = dict(state.model.named_parameters())
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    num = den = 0.0
    for path, want in jg.items():
        name, leaf = _port_name(path)
        got = names[name].grad.numpy()
        got = got.transpose(2, 3, 1, 0) if leaf == 'kernel' else got
        if path.endswith('conv/bias'):
            assert np.abs(got - want).max() <= TOL_BIAS_GRAD * gmax, path
            continue
        assert _rel(got, want) <= TOL_GRAD_LEAF, (path, _rel(got, want))
        num, den = num + float(np.sum((got - want) ** 2)), den + float(np.sum(want ** 2))
    assert (num / den) ** 0.5 <= TOL_GRAD, (num / den) ** 0.5

    # the update: the JAX optimizer's (optax RMSprop, eps outside the sqrt)
    # applied to the port's own gradients
    pgrads = _grad_tree(state.model)
    tx = jts.make_optimizer(*lr)
    updates, _ = tx.update(pgrads, tx.init(variables['params']), variables['params'])
    want_params = optax.apply_updates(variables['params'], updates)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(
            to_jax_variables(state.model)['params']), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2 ** -22, atol=1e-8,
                                   err_msg=jax.tree_util.keystr(path))
    got = to_jax_variables(state.model)['batch_stats']
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(jnew.batch_stats)):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= TOL_STATS * np.abs(b).max(), jax.tree_util.keystr(path)


def _grad_tree(model):
    """The parameters' .grad as a flax-named tree (through
    `to_jax_variables`, which reads the parameters)."""
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
        tree = to_jax_variables(model)['params']
        for p, v in zip(model.parameters(), saved):
            p.copy_(v)
    return tree


def _port_name(path):
    """'stage0/up1/u_skip/conv/kernel' -> ('stage0.up1.u_skip.conv.weight', 'kernel')."""
    *mods, leaf = path.split('/')
    return '.'.join(mods + [{'kernel': 'weight', 'scale': 'weight'}.get(leaf, leaf)]), leaf


@pytest.mark.parametrize('weights_dtype', [None, 'bf16'])
def test_inference_fn_matches_jax(weights_dtype):
    """Serving: uint8 frames of another size (80x96) -> /255 -> resize to
    64 -> normalize -> an MSPN with folded BN -> the last head (the finest
    of the last stage) -> the quarter decode, against the JAX
    `make_inference_fn` with the same arguments: the heatmaps within 1e-4
    of their largest value (read 1.5e-6, f32 and bf16 weights), the
    keypoints within 1e-3 px (read 0) and the maxvals. Folding leaves the
    heatmaps within 2e-5 of the unfolded ones (read 1.9e-6). 1 stage: the
    2-stage eval forward is held above, and each JAX build here compiles
    the model."""
    jmodel, variables = _weights(1)
    frames = np.random.RandomState(7).randint(0, 256, size=(3, 80, 96, 3)).astype(np.uint8)
    wd = (jnp.bfloat16, torch.bfloat16) if weights_dtype else (None, None)
    kw = dict(fold_bn=True, preprocess=MEANSTD, input_res=64)
    jk, jm = (np.asarray(a) for a in jax_inference_fn(
        jmodel, variables, decode='quarter', weights_dtype=wd[0], **kw)(jnp.asarray(frames)))
    jh = np.asarray(jax_inference_fn(jmodel, variables, weights_dtype=wd[0], **kw)(
        jnp.asarray(frames)))
    model = get_model('mspn', device='cpu', num_stacks=1, dtype=torch.float32, **KW)
    build = lambda decode, **k: make_inference_fn(model, variables, decode=decode,
                                                  weights_dtype=wd[1], device='cpu', **k)
    hm = build(None, **kw)(frames).numpy()
    assert hm.shape == jh.shape == (3, 16, 16, 16)
    np.testing.assert_allclose(hm, jh, rtol=0, atol=1e-4 * np.abs(jh).max())
    tk, tm = build('quarter', **kw)(frames)
    assert tk.shape == jk.shape == (3, 16, 2) and tm.shape == jm.shape == (3, 16)
    np.testing.assert_allclose(tk.numpy(), jk, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0, atol=1e-4 * np.abs(jm).max())
    unfolded = build(None, **{**kw, 'fold_bn': False})(frames).numpy()
    np.testing.assert_allclose(hm, unfolded, rtol=0, atol=2e-5 * np.abs(unfolded).max())


def _cfg(**sections):
    raw = {'DATASET': {'name': 'synthetic', 'inp_res': 64, 'out_res': 16, 'num_samples': 8},
           'MODEL': {'arch': 'mspn', 'num_stacks': 1, 'up_channel_num': 64},
           'TRAIN': {'epochs': 1, 'train_batch': 4, 'val_batch': 4, 'precision': 'f32'},
           'COMMON': {'dataset': 'mpii', 'in_res': 64, 'out_res': 16}}
    for k, v in sections.items():
        raw[k] = {**raw.get(k, {}), **v}
    return raw


def test_estimator_runs_mspn(rng):
    """The Estimator on arch=mspn (out_res and the width from the config)
    against the JAX Estimator on the same weights, both preprocesses."""
    jmodel, variables = _weights(1)
    raw = _cfg()
    test = Estimator(tconfig.load_config(raw=raw), variables=variables, device='cpu')
    assert isinstance(test.model, MSPN) and test.model.out_res == 16
    for m in test.model.modules():
        if hasattr(m, 'compute_dtype'):
            m.compute_dtype = torch.float32
    jest = JaxEstimator(jconfig.load_config(raw=raw), variables['params'],
                        variables['batch_stats'])
    jest.model = jmodel
    frames = rng.randint(0, 256, size=(2, 48, 80, 3)).astype(np.uint8)
    for device_preprocess in (True, False):
        got = test._heatmaps(frames, device_preprocess).numpy()
        ref = np.asarray(jest._heatmaps(frames, device_preprocess))
        assert got.shape == ref.shape == (2, 16, 16, 16)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
        kps = test.run_batch(frames, device_preprocess)
        ref_kps = jest.run_batch(frames, device_preprocess)
        assert kps.shape == (2, 16, 2)
        d = np.abs(kps - ref_kps).max(-1)
        assert (d == 0).mean() >= 0.95 and d.max() <= 80 / 16, d
        one = test.run(frames[0], time_it=False, device_preprocess=device_preprocess)
        np.testing.assert_array_equal(one, kps[0])


def test_config_path_and_refusals(tmp_path, monkeypatch):
    """MODEL.arch=mspn through the config: out_res and the decoder width
    reach the model (tests/test_mspn.py's regression), MODEL.fuse_block
    resolves per arch (on for hg, off for mspn; an explicit true with mspn
    raises, as the JAX factory does), and the factory refuses what MSPN
    does not implement."""
    cfg = tconfig.load_config(raw=_cfg(DATASET={'out_res': 32},
                                       COMMON={'checkpoint_dir': str(tmp_path)}))
    assert cfg.model.fuse_block is False
    tr = Trainer(cfg, verbose=False, device='cpu')
    assert isinstance(tr.model, MSPN)
    assert tr.model.out_res == 32 and tr.model.up_channel_num == 64
    assert tconfig.load_config(raw={'MODEL': {'arch': 'hg'}}).model.fuse_block is True
    assert tconfig.load_config().model.fuse_block is True
    assert tconfig.load_config(raw={'MODEL': {'fuse_block': False}}).model.fuse_block is False
    on = tconfig.load_config(raw=_cfg(), overrides=['MODEL.fuse_block=true'])
    with pytest.raises(ValueError, match='fuse_block'):
        model_from_config(on.model, num_classes=16, out_res=16, device='cpu')
    with pytest.raises(ValueError, match='fuse_block'):
        Trainer(on, verbose=False, device='cpu')
    with pytest.raises(ValueError, match='fuse_block'):
        Estimator(on, variables={}, device='cpu')
    from hourglass_pose_estimation_torch import serve_http
    with pytest.raises(ValueError, match='fuse_block'):
        serve_http.build_inference(on, str(tmp_path / 'none.pt'), device='cpu')
    with pytest.raises(ValueError, match='remat'):
        Trainer(tconfig.load_config(raw=_cfg(TRAIN={'remat': True})), verbose=False,
                device='cpu')
    base = dict(device='cpu', num_stacks=1, num_classes=16)
    for bad in (dict(bn_stat_samples=2), dict(bn_axis_name='batch'), dict(fuse_upsample=True)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            get_model('mspn', **base, **bad)
    with pytest.raises(ValueError, match='skip_mode'):
        get_model('mspn', **base, skip_mode='concat')
    # serve_http builds the config's MSPN with DATASET.out_res
    from hourglass_pose_estimation_torch import export
    seen = []
    monkeypatch.setattr(export, 'make_inference_fn', lambda model, *a, **k: seen.append(model))
    weights = tmp_path / 'weights.pt'
    torch.save({}, weights)             # the stand-in above loads nothing
    serve_http.build_inference(cfg, str(weights), device='cpu')
    assert isinstance(seen[0], MSPN) and seen[0].out_res == 32
    # num_blocks is not the width; arch=hg refuses the MSPN-only knob
    m = get_model('mspn', **base, num_blocks=1)
    assert m.up_channel_num == 256 and m.out_res == 64
    with pytest.raises(ValueError, match='up_channel_num'):
        get_model('hg', **base, up_channel_num=64)


def test_trainer_and_evaluate_only_cli_run_mspn(tmp_path, capsys):
    """`train_and_evaluate` with MODEL.arch=mspn and no other override of
    the model: 2 epochs of 2 steps with a snapshot each epoch (every value
    finite, the run name carries the arch), then COMMON.evaluate_only on the
    last checkpoint reads the same validation as the run's last epoch, and
    the `estimate` CLI draws its keypoints."""
    cfg = tmp_path / 'mspn.yaml'
    cfg.write_text('DATASET:\n  name: synthetic\n  inp_res: 64\n  out_res: 16\n'
                   '  num_samples: 8\nMODEL:\n  arch: mspn\n  num_stacks: 1\n'
                   'TRAIN:\n  epochs: 2\n  train_batch: 4\n  val_batch: 4\n'
                   '  precision: f32\n  learning_rate: 2.5e-5\n')
    over = [f'COMMON.checkpoint_dir={tmp_path}', 'COMMON.snapshot=1']
    assert train_and_evaluate.main([str(cfg)] + over + ['--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert "model 'mspn', stacks=1, params=" in out
    ckpts = tmp_path / 'synthetic_mspn_s1_non-mobile_all' / 'ckpts'
    assert sorted(p.name for p in ckpts.iterdir())[-2:] == ['checkpoint_1', 'checkpoint_2']
    vals = [ln for ln in out.splitlines() if ln.strip().startswith('val:')]
    assert len(vals) == 2 and 'nan' not in out and 'inf' not in out
    assert train_and_evaluate.main([str(cfg)] + over + [
        'COMMON.evaluate_only=True', f'COMMON.resume={ckpts / "checkpoint_2"}',
        '--device', 'cpu']) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('loss ')][0]
    loss, pck = vals[-1].split('loss')[1].split('| pck')
    assert line == f'loss {float(loss):.5f} | pck {float(pck):.4f}'
    # the estimate CLI on the same checkpoint draws 16 keypoints
    import cv2
    from hourglass_pose_estimation_torch import estimate
    img, dest = tmp_path / 'frame.jpg', tmp_path / 'drawn.jpg'
    cv2.imwrite(str(img), np.random.RandomState(4).randint(0, 256, (48, 80, 3)).astype(np.uint8))
    assert estimate.main([str(cfg), f'COMMON.resume={ckpts / "checkpoint_2"}',
                          f'COMMON.image_path={img}', f'COMMON.dest_path={dest}',
                          'COMMON.dataset=mpii', 'COMMON.in_res=64', 'COMMON.out_res=16',
                          '--device', 'cpu']) == 0
    assert cv2.imread(str(dest)).shape == (48, 80, 3)
