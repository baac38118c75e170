"""The port's trainer path vs the JAX package's, on the CPU: the config
(every configs/*.yaml, trainer keys included), the Loader's epoch order, the
crop-aware canvases, the Prefetcher, and the Trainer itself (2 epochs of 2
steps, BN frozen from epoch 2, MODEL.fuse_block on: the JAX Trainer's fused
bottleneck in the frozen epoch and in every validation pass; the port's
standard blocks in f32, as an f32 model takes, and its fused bottleneck in
bf16) with the JAX weights carried over and the JAX augmentation draws
injected. f32 (and bf16 for the trainers), 1 stack, synthetic data; 64^2 ->
16^2, and 128^2 -> 32^2 for the trainers (see TOL_LOSS)."""

import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu import config as jconfig
from hourglass_pose_estimation_tpu.data import Loader as JaxLoader
from hourglass_pose_estimation_tpu.data import Synthetic as JaxSynthetic
from hourglass_pose_estimation_tpu.data.pipeline import (
    sample_augmentations as jax_sample)
from hourglass_pose_estimation_tpu.runner.trainer import Trainer as JaxTrainer

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch import train_and_evaluate
from hourglass_pose_estimation_torch.data import Loader, Prefetcher, Synthetic
from hourglass_pose_estimation_torch.ops.hopper import fused_bottleneck
from hourglass_pose_estimation_torch.runner import Trainer
from hourglass_pose_estimation_torch.runner import train_state as tts
from hourglass_pose_estimation_torch.weights import (
    load_jax_variables, to_jax_variables)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# the trainers, 2 epochs x 2 steps at lr 1e-6, 128^2 -> 32^2 input. At
# 64^2 the hourglass's bottom level is 1x1 and its batch statistics come
# from 4 values: the two packages' f32 sums differ there by 2e-4 of a
# statistic, which RMSprop's sign-like update (lr * 10 * sign(g) per
# parameter) turns into 1e-3 between the losses of step 2 (read here); at
# 128^2 the same noise leaves every epoch's train and val loss 2.8e-5 apart
# (read), held at 1.5e-4, and the PCKs equal (held at 1e-6). The BatchNorm
# statistics: 1.8e-4 of a leaf's largest value (read), held at 1e-3. The
# parameters: their moves from the common start agree to 5.7e-2 relative
# L2 over the whole model (read; 0.25% of the elements moved in opposite
# directions, on gradients of rounding noise), held at 0.2, and no element
# is further apart than the two moves allow (twice the JAX parameters'
# largest move).
TOL_LOSS = 1.5e-4
TOL_PCK = 1e-6
TOL_STATS = 1e-3
TOL_MOVES = 0.2
# TRAIN.precision bf16: the port's fused bottlenecks run in the frozen epoch
# and in validation, as the JAX Trainer's do. The epochs' losses read at most
# 2.7e-3 apart, held at 1.5e-2; the PCKs equal; the BatchNorm statistics
# 2.4e-2 of a leaf's largest value, held at 0.1; the parameters' moves 0.43
# apart (bf16 noise in the signs that RMSprop's first update follows), held
# at 0.8. The validation of the JAX Trainer's weights of each epoch through
# the port's eval step gives the JAX Trainer's PCK too (held equal).
TOL = {'f32': (TOL_LOSS, TOL_MOVES, TOL_STATS), 'bf16': (1.5e-2, 0.8, 0.1)}
# the fused blocks' backward calls of the frozen epoch: none in f32 (the
# kernel's scope is bf16; the port's blocks take the standard path there,
# the JAX Trainer's its fused bottleneck); in bf16 6 fused blocks (layer3,
# hg0.up1_l4, res0 at 32^2; low1_l4, up1_l3, low3_l4 at 16^2) per step
BACKWARDS = {'f32': 0, 'bf16': 6 * 2}
# the crop-aware canvases: the port samples in float32, the JAX package
# through cv2's warpAffine, whose rounding differs: equal at 64^2 and at
# most 1 level apart at 2.7e-5 of the values at 256^2 (read here), held at
# 1 level and 1e-4 of the values
CANVAS_MAX_LEVELS = 1
CANVAS_MAX_SHARE = 1e-4


def _raw_cfg(tmp, **extra):
    raw = {
        'DATASET': {'name': 'synthetic', 'inp_res': 128, 'out_res': 32, 'sigma': 1,
                    'scale_factor': 0.25, 'rot_factor': 30, 'num_samples': 8,
                    'canvas_mode': 'image'},
        'MODEL': {'arch': 'hg', 'num_stacks': 1, 'num_blocks': 1, 'fuse_block': True},
        'TRAIN': {'epochs': 2, 'train_batch': 4, 'val_batch': 3, 'precision': 'f32',
                  'learning_rate': 1e-6, 'schedule': [1], 'gamma': 0.5,
                  'freeze_bn_after_epoch': 1, 'data_parallel': 1},
        'COMMON': {'checkpoint_dir': str(tmp), 'snapshot': 1, 'seed': 0},
    }
    for k, v in extra.items():
        raw[k] = {**raw[k], **v}
    return raw


# --- config

@pytest.mark.parametrize('path', sorted(p.name for p in (REPO / 'configs').glob('*.yaml')))
def test_every_config_loads_to_equal_values(path):
    """Every section's every field, the trainer keys among them, equal in
    both packages, with the trainer keys set on the command line too. One
    default differs by design: MODEL.fuse_block (on in the port); and
    MODEL.width is the port's alone (the width of its HRNet, which the JAX
    package does not have)."""
    overrides = ['TRAIN.freeze_bn_after_epoch=40', 'TRAIN.remat=true',
                 'TRAIN.bn_stat_samples=8', 'TRAIN.microbatches=4',
                 'DATASET.canvas=320', 'DATASET.canvas_mode=image',
                 'COMMON.skeleton=true']
    for ov in ([], overrides):
        j = jconfig.load_config(str(REPO / 'configs' / path), overrides=ov)
        t = tconfig.load_config(str(REPO / 'configs' / path), overrides=ov)
        for section in ('dataset', 'model', 'train', 'common', 'eval'):
            a = dataclasses.asdict(getattr(t, section))
            b = dataclasses.asdict(getattr(j, section))
            if section == 'model':
                assert a.pop('fuse_block') == (a['arch'] == 'hg') and not b.pop('fuse_block')
                assert a.pop('width') == 48 and 'width' not in b
            assert a == b, (path, section)
        assert t.run_name() == j.run_name()


@pytest.mark.parametrize('raw', [{'DATASET': {'canvas_mode': 'tile'}},
                                 {'TRAIN': {'precision': 'f16'}},
                                 {'TRAIN': {'explicit_collectives': True,
                                            'model_parallel': 2}}])
def test_config_validation_matches_jax(raw):
    for load in (jconfig.load_config, tconfig.load_config):
        with pytest.raises(ValueError):
            load(raw=raw)


# --- Loader, canvases, Prefetcher

class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize('n,bs,shuffle,drop_last,shard', [
    (10, 4, True, True, (0, 1)),       # shuffle, ragged tail dropped
    (10, 4, False, False, (0, 1)),     # padded tail with its mask
    (11, 4, True, False, (0, 1)),      # both
    (12, 4, True, True, (1, 2)),       # this process's half of each batch
    (9, 4, False, False, (0, 2))])
def test_loader_epochs_equal_jax(n, bs, shuffle, drop_last, shard):
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last, shard=shard)
    ours, ref = Loader(_Sized(n), bs, **kw), JaxLoader(_Sized(n), bs, **kw)
    assert len(ours) == len(ref)
    for _ in range(3):                                  # one stream of epochs
        a, b = ours.epoch_indices(), ref.epoch_indices()
        assert len(a) == len(b)
        for (ia, va), (ib, vb) in zip(a, b):
            assert ia.dtype == ib.dtype and va.dtype == vb.dtype
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(va, vb)
    with pytest.raises(ValueError):
        Loader(_Sized(8), 3, shuffle=False, shard=(0, 2))


@pytest.mark.parametrize('res', [64, 256])
def test_crop_aware_canvases_match_jax(res):
    kw = dict(num_samples=6, inp_res=res, out_res=res // 4, sigma=1,
              scale_factor=0.25, rot_factor=30)
    for train in (True, False):
        ours = Synthetic(train, **kw).canvas_batch([0, 3, 5], canvas=res, crop_aware=True)
        ref = JaxSynthetic(train, **kw).canvas_batch([0, 3, 5], canvas=res, crop_aware=True)
        assert ours.keys() == ref.keys()
        for k in ours:
            if k != 'canvas':
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        diff = np.abs(ours['canvas'].astype(int) - ref['canvas'])
        assert diff.max() <= CANVAS_MAX_LEVELS
        assert (diff > 0).mean() <= CANVAS_MAX_SHARE
        assert bool((ours['canvas_scale'] < 1).all())       # regions downscaled


def test_prefetcher_keeps_order_stops_and_raises():
    rng = np.random.RandomState(0)
    delays = rng.uniform(0, 0.01, 12)

    def produce(i):
        time.sleep(delays[i])
        return i * 10

    got = [(b, i) for b, i in Prefetcher(range(12), produce, depth=2)]
    assert got == [(i * 10, i) for i in range(12)]

    started = threading.Event()

    def slow(i):
        started.set()
        time.sleep(0.05)
        return i

    p = Prefetcher(range(1000), slow, depth=2)
    it = iter(p)
    assert next(it) == (0, 0) and started.is_set()
    p.close()
    assert not p._thread.is_alive()

    def failing(i):
        if i == 3:
            raise OSError('no such image')
        return i

    seen = []
    with pytest.raises(OSError, match='no such image'):
        for b, _ in Prefetcher(range(6), failing):
            seen.append(b)
    assert seen == [0, 1, 2]


# --- the Trainer against the JAX Trainer

def _jax_draws(monkeypatch, seed, epochs, steps):
    """The port's train steps draw through `sample_augmentations`: hand
    them the JAX Trainer's draws, key by key (PRNGKey(seed + 1) split once
    per epoch, the step folded in)."""
    keys, rng = [], jax.random.PRNGKey(seed + 1)
    for e in range(epochs):
        rng, sub = jax.random.split(rng)
        keys += [jax.random.fold_in(sub, e * steps + s) for s in range(steps)]
    keys = iter(keys)
    plain = tts.sample_augmentations

    def draws(gen, scales, *, scale_factor, rot_factor, train):
        if not train:
            return plain(gen, scales, scale_factor=scale_factor,
                         rot_factor=rot_factor, train=False)
        return tuple(torch.from_numpy(np.array(d)) for d in jax_sample(
            next(keys), jnp.asarray(scales.numpy()), scale_factor=scale_factor,
            rot_factor=rot_factor, train=True))

    monkeypatch.setattr(tts, 'sample_augmentations', draws)


def _history(trainer, log, weights=None):
    """Each epoch's (train loss, train PCK, val loss, val PCK) of a JAX
    Trainer, from its own epoch methods; with `weights`, also the variables
    each validation ran on."""
    te, ev = trainer._train_epoch, trainer._evaluate

    def evaluate():
        if weights is not None:
            weights.append(jax.device_get({'params': trainer.state.params,
                                           'batch_stats': trainer.state.batch_stats}))
        log[-1].extend(ev())
        return tuple(log[-1][2:])
    trainer._train_epoch = lambda *a: log.append(list(te(*a))) or tuple(log[-1])
    trainer._evaluate = evaluate


def test_trainer_matches_jax_trainer(tmp_path, monkeypatch):
    _trainer_matches_jax(tmp_path, monkeypatch, 'f32')


def test_bf16_trainer_with_fused_blocks_matches_jax_trainer(tmp_path, monkeypatch):
    _trainer_matches_jax(tmp_path, monkeypatch, 'bf16')


def _trainer_matches_jax(tmp_path, monkeypatch, precision, **over):
    """The port's Trainer against the JAX Trainer on `_raw_cfg` with
    TRAIN.precision and the sections of `over` merged in: the same initial
    weights, and under the device pipeline the JAX draws (the host pipeline
    draws from the same RandomState seeds in both)."""
    prec = {**over, 'TRAIN': {'precision': precision, **over.get('TRAIN', {})}}
    raw = _raw_cfg(tmp_path / 'jax', **prec)
    jt = JaxTrainer(jconfig.load_config(raw=raw), verbose=False)
    jlog, jweights = [], []
    _history(jt, jlog, jweights)
    jt.train()

    t = Trainer(tconfig.load_config(raw=_raw_cfg(tmp_path / 'port', **prec)),
                verbose=False, device='cpu')
    first = jt._init_state()
    init = jax.device_get({'params': first.params, 'batch_stats': first.batch_stats})
    load_jax_variables(t.model, jax.tree.map(np.asarray, init))
    if t.device_pipeline:
        _jax_draws(monkeypatch, 0, 2, t.steps_per_epoch)
    calls = fused_bottleneck.backward_calls
    assert t.train() == jt.best_acc

    assert t.steps_per_epoch == jt.steps_per_epoch == 2
    assert fused_bottleneck.backward_calls == calls + BACKWARDS[precision]
    tol_loss, tol_moves, tol_stats = TOL[precision]
    assert [h['epoch'] for h in t.history] == [1, 2]
    for h, j in zip(t.history, jlog):
        ours = (h['train_loss'], h['train_acc'], h['val_loss'], h['val_acc'])
        np.testing.assert_allclose(ours[0::2], j[0::2], rtol=tol_loss)
        np.testing.assert_allclose(ours[1::2], j[1::2], atol=TOL_PCK)
    assert t.state.step == int(jt.state.step) == 4
    got = to_jax_variables(t.model)
    want = jax.device_get({'params': jt.state.params, 'batch_stats': jt.state.batch_stats})
    start = jax.tree.leaves(init['params'])
    ours = np.concatenate([(a - c).ravel() for a, c in zip(jax.tree.leaves(got['params']), start)])
    ref = np.concatenate([(np.asarray(b) - c).ravel()
                          for b, c in zip(jax.tree.leaves(want['params']), start)])
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) <= tol_moves
    assert np.abs(ours - ref).max() <= 2 * np.abs(ref).max()
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got['batch_stats']),
                            jax.tree.leaves(want['batch_stats'])):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= tol_stats * np.abs(b).max(), jax.tree_util.keystr(path)
    # the same snapshots in both
    names = lambda root: sorted(p.name for p in (root / 'ckpts').iterdir())
    assert names(tmp_path / 'port') == ['best', 'checkpoint_1', 'checkpoint_2']
    assert set(names(tmp_path / 'jax')) == set(names(tmp_path / 'port'))
    # the port's validation on the JAX Trainer's weights of each epoch
    assert len(jweights) == 2
    for w, j in zip(jweights, jlog):
        load_jax_variables(t.model, jax.tree.map(np.asarray, w))
        val_loss, val_acc = t._evaluate()
        np.testing.assert_allclose(val_loss, j[2], rtol=tol_loss)
        np.testing.assert_allclose(val_acc, j[3], atol=TOL_PCK)


def test_cli_trains_on_the_cpu_when_asked(tmp_path, capsys):
    argv = [str(REPO / 'configs' / 'train_synthetic_tiny.yaml'),
            f'COMMON.checkpoint_dir={tmp_path}', 'DATASET.num_samples=8',
            'TRAIN.train_batch=4', 'TRAIN.val_batch=4', 'TRAIN.epochs=1',
            'COMMON.snapshot=1', '--device', 'cpu']
    assert train_and_evaluate.main(argv) == 0
    out = capsys.readouterr().out
    assert 'best val pck:' in out and 'Epoch 1/1' in out
    # under the JAX CLI's run name
    ckpt = tmp_path / 'synthetic_hg_s1_non-mobile_all' / 'ckpts' / 'checkpoint_1'
    assert ckpt.is_file()
    # the standalone evaluator on that checkpoint: the val reading of the
    # epoch that wrote it, and the official (OKS) table
    val = [ln for ln in out.splitlines() if ln.strip().startswith('val:')][-1]
    assert train_and_evaluate.main(argv[:-2] + [
        'COMMON.evaluate_only=true', f'COMMON.resume={ckpt}', 'EVAL.official=true',
        '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert f'Loaded model {ckpt}' in out and 'AR50:' in out and 'mean_oks:' in out
    got = [ln for ln in out.splitlines() if ln.startswith('loss ')][0]
    assert got.split() == ['loss'] + val.split()[2:3] + ['|', 'pck'] + val.split()[5:6], (got, val)


@pytest.mark.parametrize('override,error,match', [
    pytest.param('TRAIN.pipeline_parallel=2', ValueError, 'pipeline_parallel 2',
                 id='TRAIN.pipeline_parallel=2-item 13'),
    pytest.param('TRAIN.explicit_collectives=true', None, None,
                 id='TRAIN.explicit_collectives=true-item 13'),
    pytest.param('TRAIN.model_parallel=2', ValueError, 'model_parallel=2 needs 2 ranks',
                 id='TRAIN.model_parallel=2-item 13'),
    pytest.param('TRAIN.data_parallel=2', ValueError, 'world size 1',
                 id='TRAIN.data_parallel=2-item 13')])
def test_trainer_refuses_what_one_card_lacks(tmp_path, override, error, match):
    """In one process: pipeline parallelism (item 13b) refuses this
    config's one stack over 2 stages, as the JAX Trainer does (its other
    refusals, and the ranks it needs, are in test_torch_port_pipeline.py);
    tensor parallelism (item 13c) and data_parallel=2 ask for more ranks
    than the world has (tensor parallelism on its ranks:
    test_torch_port_tensor_parallel.py); the explicit-collectives step
    runs, at world size 1."""
    cfg = tconfig.load_config(raw=_raw_cfg(tmp_path), overrides=[override])
    if error is not None:
        with pytest.raises(error, match=match):
            Trainer(cfg, verbose=False, device='cpu')
        return
    cfg = tconfig.load_config(raw=_raw_cfg(tmp_path), overrides=[
        override, 'TRAIN.epochs=1', 'TRAIN.freeze_bn_after_epoch=0', 'DATASET.inp_res=64',
        'DATASET.out_res=16'])
    t = Trainer(cfg, verbose=False, device='cpu')
    assert (t.mesh.world, t.mesh.group) == (1, None)
    t.train()
    assert t.history[0]['epoch'] == 1 and all(np.isfinite(v) for v in t.history[0].values())


@pytest.mark.parametrize('override', ['DATASET.device_pipeline=false', 'DATASET.name=mpii'])
def test_trainer_runs_the_host_pipeline_and_the_readers(tmp_path, override):
    """The host cv2 pipeline (synthetic, in memory) and an MPII tree of JPEG
    files (the device pipeline) each train an epoch and validate."""
    from hourglass_pose_estimation_torch.data import fabricate
    img, ann, _ = fabricate.mpii_tree(str(tmp_path / 'mpii'), np.random.RandomState(0),
                                      n_train=4, n_valid=3, image_size=(160, 120),
                                      scales=(0.3, 0.5))
    cfg = tconfig.load_config(raw=_raw_cfg(tmp_path), overrides=[
        override, 'DATASET.inp_res=64', 'DATASET.out_res=16', 'TRAIN.epochs=1',
        'TRAIN.freeze_bn_after_epoch=0', f'DATASET.image_path={img}',
        f'DATASET.annotation_path={ann}'])
    t = Trainer(cfg, verbose=False, device='cpu')
    host = override == 'DATASET.device_pipeline=false'
    assert (t.device_pipeline, t.train_ds.name) == ((False, 'synthetic') if host else (True, 'mpii'))
    t.train()
    h = t.history[0]
    assert h['epoch'] == 1 and all(np.isfinite(v) for v in h.values())
    assert (tmp_path / 'ckpts' / 'checkpoint_1').is_file()
