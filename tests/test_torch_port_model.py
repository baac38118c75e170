"""Port model and serving function vs the JAX package, on the CPU in f32.

The port's HourglassNet is filled from a flax HourglassNet's variables
through `weights.load_jax_variables` and must compute the same heatmaps
(rtol 1e-3, atol 1e-4, as tests/test_torch_import.py holds the JAX model
to the reference), with the fused switches off and on. The whole
serving function (uint8 frames -> keypoints) is held to the JAX
`make_inference_fn` with the same arguments."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu.export import (
    make_inference_fn as jax_make_inference_fn)
from hourglass_pose_estimation_tpu.models import HourglassNet as JaxNet

from hourglass_pose_estimation_torch.export import (
    fold_batchnorm, make_inference_fn)
from hourglass_pose_estimation_torch.models import HourglassNet, get_model
from hourglass_pose_estimation_torch.models.modules import Bottleneck
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.weights import (
    load_jax_variables, to_jax_variables)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream: the session-wide `rng` of conftest.py
    is shared by every file a test worker runs, so its draws here would
    depend on which files ran before."""
    return np.random.RandomState(0)

MPII_MEANSTD = ((0.406822, 0.444257, 0.466048), (0.228944, 0.232618, 0.236498))


def _randomize(tree, rng):
    """Non-trivial BN affine and running statistics (kernels keep their
    init), so every leaf of the carried-over tree carries signal."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == 'var':
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ('mean', 'bias'):
            v = rng.normal(0, 0.1, v.shape)
        elif k == 'scale':
            v = 1 + rng.normal(0, 0.1, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _jax_model(seed, **kw):
    model = JaxNet(dtype=jnp.float32, **kw)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                   train=False)
    return model, _randomize(jax.tree.map(np.asarray, dict(v)),
                             np.random.RandomState(seed))


@pytest.mark.parametrize('stacks,mobile,skip_mode', [
    (1, False, 'sum'), (2, False, 'sum'), (1, False, 'concat'),
    (1, True, 'sum')])
def test_hourglassnet_eval_matches_flax(rng, stacks, mobile, skip_mode):
    kw = dict(num_stacks=stacks, num_blocks=1, num_classes=4, mobile=mobile,
              skip_mode=skip_mode, num_feats=16)
    jmodel, variables = _jax_model(stacks + 10 * mobile, **kw)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    # JAX's fuse_upsample calls Pallas outside interpret mode and cannot
    # run on the CPU; the port's fused merge is held to the unfused JAX
    # forward, which is the same math
    for fuse in (False, True):
        model = HourglassNet(dtype=torch.float32, fuse_block=fuse,
                             fuse_upsample=fuse and skip_mode == 'sum', **kw)
        load_jax_variables(model, variables)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape == (stacks, 2, 16, 16, 4)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4,
                                   err_msg=f'fuse={fuse}')


@pytest.mark.parametrize('stacks,stat_samples', [(2, 0), (1, 2)])
def test_hourglassnet_train_matches_flax(stacks, stat_samples):
    """Train mode (batch statistics, from the first `bn_stat_samples`
    samples when set, through `hg`): the heatmaps and the updated running
    statistics against flax `apply(mutable=['batch_stats'])`, with the
    pool and upsample routes off and on (their plain versions here).

    At 128^2 the hourglass's bottom level is 2x2, so its one-pass variance
    is taken over 4 values per sample: f32 cancellation there, in another
    summation order, reads up to 1.8e-4 relative L2 on a stack's heatmaps
    and 2.7e-4 of a statistics leaf's largest value over six inputs; held
    at 1e-3. (At 64^2 the bottom is 1x1 and one input in a few reads
    2.6e-3: too ill-conditioned to compare.)"""
    kw = dict(num_stacks=stacks, num_blocks=1, num_classes=4, num_feats=16)
    res = 128
    jmodel, variables = _jax_model(stacks, bn_stat_samples=stat_samples, **kw)
    x = np.random.RandomState(stacks).normal(size=(4, res, res, 3)).astype(np.float32)
    ref, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                            mutable=['batch_stats'])
    ref, ref_stats = np.asarray(ref), jax.tree.leaves(mut['batch_stats'])
    for fuse in (False, True):
        model = get_model('hg', device='cpu', dtype=torch.float32,
                          bn_stat_samples=stat_samples, fuse_block=fuse,
                          fuse_upsample=fuse, **kw)
        load_jax_variables(model, variables)
        got = model(torch.from_numpy(x), train=True).detach().numpy()
        assert got.shape == ref.shape == (stacks, 4, res // 4, res // 4, 4)
        for s in range(stacks):
            rel = np.linalg.norm(got[s] - ref[s]) / np.linalg.norm(ref[s])
            assert rel <= 1e-3, (fuse, s, rel)
        stats = jax.tree.leaves(to_jax_variables(model)['batch_stats'])
        assert len(stats) == len(ref_stats)
        for a, b in zip(stats, ref_stats):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), fuse


def test_fuse_block_gating_matches_jax():
    """Which blocks take the fused kernel: the JAX gating (identity
    residual, stride 1, non-mobile, >= fuse_min_hw a side, eval only),
    within the kernel's scope (bf16 compute, PLANES planes)."""
    x16 = torch.zeros(1, 256, 16, 16)
    assert Bottleneck(256, 128, fuse_block=True)._fuses(x16, train=False)
    assert not Bottleneck(256, 128, fuse_block=True)._fuses(x16, train=True)
    assert not Bottleneck(256, 128)._fuses(x16, train=False)
    assert not Bottleneck(256, 64, fuse_block=True)._fuses(x16, False)
    assert not Bottleneck(256, 128, stride=2, fuse_block=True)._fuses(x16, False)
    assert not Bottleneck(256, 128, mobile=True, fuse_block=True)._fuses(x16, False)
    assert not Bottleneck(256, 128, fuse_block=True)._fuses(
        torch.zeros(1, 256, 8, 16), False)
    assert not Bottleneck(256, 128, fuse_block=True, dtype=torch.float32)._fuses(x16, False)
    assert not Bottleneck(32, 16, fuse_block=True)._fuses(torch.zeros(1, 32, 16, 16), False)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fused_path_takes_only_bf16_models(monkeypatch, dtype):
    """MODEL.fuse_block on: a 1-stack model at 64^2 calls the fused
    bottleneck only in bf16 compute, the kernel's one type; in f32 every
    block runs the standard path (on the card the kernel would raise)."""
    from hourglass_pose_estimation_torch.models import modules
    calls = []
    fused = modules.fused_bottleneck
    monkeypatch.setattr(modules, 'fused_bottleneck',
                        lambda x, p, *a, **k: calls.append(x.dtype) or fused(x, p, *a, **k))
    torch.manual_seed(0)
    model = get_model('hg', device='cpu', num_stacks=1, num_classes=16, dtype=dtype,
                      fuse_block=True, fuse_upsample=True)
    with torch.no_grad():
        out = model(torch.rand(1, 64, 64, 3))
    assert out.shape == (1, 1, 16, 16, 16) and bool(torch.isfinite(out.float()).all())
    if dtype == torch.float32:
        assert calls == []
    else:
        # layer3, hg0.up1_l4 and res0 at 16^2
        assert calls == [torch.bfloat16] * 3


def test_train_mode_raises_until_the_training_slice():
    """Train mode is ported (it runs and moves the running statistics), and
    so are remat (the trainer slice), MSPN (its own slice) and cross-rank
    BN statistics (`bn_axis_name='data'`, the parallel slice; the port has
    no other axis)."""
    model = HourglassNet(num_stacks=1, num_classes=4, num_feats=16)
    before = model.bn1.running_var.clone()
    out = model(torch.rand(2, 64, 64, 3), train=True)
    assert out.shape == (1, 2, 16, 16, 4) and bool(torch.isfinite(out).all())
    assert not torch.equal(model.bn1.running_var, before)
    assert get_model('hg', device='cpu', num_stacks=1, num_classes=4, remat=True).remat
    synced = get_model('hg', device='cpu', num_stacks=1, num_classes=4, bn_axis_name='data')
    assert {m.axis_name for m in synced.modules() if isinstance(m, BatchNorm)} == {'data'}
    with pytest.raises(ValueError, match="'data'"):
        get_model('hg', device='cpu', num_stacks=1, num_classes=4, bn_axis_name='batch')
    from hourglass_pose_estimation_torch.models import MSPN
    mspn = get_model('mspn', device='cpu', num_stacks=1, num_classes=4)
    assert isinstance(mspn, MSPN) and mspn.num_stacks == 1 and mspn.num_classes == 4


def test_load_jax_variables_is_strict():
    _, variables = _jax_model(0, num_stacks=1, num_classes=4, num_feats=16)
    two = HourglassNet(num_stacks=2, num_classes=4, num_feats=16)
    with pytest.raises(KeyError, match='missing'):
        load_jax_variables(two, variables)
    extra = {'params': {**variables['params'],
                        'bogus': {'kernel': np.zeros((1, 1, 2, 2))}},
             'batch_stats': variables['batch_stats']}
    with pytest.raises(KeyError, match='unexpected params/bogus/kernel'):
        load_jax_variables(HourglassNet(num_stacks=1, num_classes=4,
                                        num_feats=16), extra)


def test_fold_batchnorm_keeps_the_forward(rng):
    _, variables = _jax_model(3, num_stacks=1, num_classes=4, num_feats=16)
    model = HourglassNet(num_stacks=1, num_classes=4, num_feats=16,
                         dtype=torch.float32)
    load_jax_variables(model, variables)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        got = fold_batchnorm(model)(x)
    assert float(model.bn1.running_mean.abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('weights_dtype', [None, 'bf16'])
def test_inference_fn_matches_jax(weights_dtype):
    """uint8 frames of another size (80x96) -> /255 -> resize to 64 ->
    normalize -> 2-stack net -> quarter decode -> input-frame pixels."""
    kw = dict(num_stacks=2, num_blocks=1, num_classes=16, num_feats=16)
    jmodel, variables = _jax_model(5, **kw)
    frames = np.random.RandomState(7).randint(
        0, 256, size=(3, 80, 96, 3)).astype(np.uint8)
    jfn = jax_make_inference_fn(
        jmodel, variables, decode='quarter', fold_bn=True,
        weights_dtype=jnp.bfloat16 if weights_dtype else None,
        preprocess=MPII_MEANSTD, input_res=64)
    jk, jm = (np.asarray(a) for a in jfn(jnp.asarray(frames)))

    model = HourglassNet(dtype=torch.float32, fuse_block=True,
                         fuse_upsample=True, **kw)
    fn = make_inference_fn(
        model, variables, decode='quarter', fold_bn=True,
        weights_dtype=torch.bfloat16 if weights_dtype else None,
        preprocess=MPII_MEANSTD, input_res=64, device='cpu')
    tk, tm = fn(frames)
    assert tk.shape == jk.shape == (3, 16, 2)
    assert tm.shape == jm.shape == (3, 16)
    np.testing.assert_allclose(tk.numpy(), jk, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-5, atol=1e-5)

    hfn = make_inference_fn(model, variables, fold_bn=True, device='cpu',
                            preprocess=MPII_MEANSTD, input_res=64)
    jh = jax_make_inference_fn(jmodel, variables, fold_bn=True,
                               preprocess=MPII_MEANSTD, input_res=64)
    np.testing.assert_allclose(hfn(frames).numpy(),
                               np.asarray(jh(jnp.asarray(frames))),
                               rtol=1e-3, atol=1e-4)


def test_inference_fn_takes_port_state_dict(rng):
    model = get_model('hg', device='cpu', num_stacks=1, num_classes=4,
                      num_feats=16, dtype=torch.float32)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    fn = make_inference_fn(model, model.state_dict(), device='cpu')
    with torch.no_grad():
        ref = model(torch.from_numpy(x))[-1]
    np.testing.assert_allclose(fn(x).numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
