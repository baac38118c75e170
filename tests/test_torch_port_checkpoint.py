"""The port's checkpoints and the Trainer's use of them, and remat, on the
CPU: a save/restore round trip is bit-exact; an optimizer state of another
layout restores params, statistics and step with a fresh optimizer; a broken
file raises; an absent resume path starts fresh; the learning-rate
fast-forward of a step-0 checkpoint; the snapshot and `best` cadence; and a
rematerialised train step against the plain one."""

import numpy as np
import pytest
import torch

from hourglass_pose_estimation_torch.config import load_config
from hourglass_pose_estimation_torch.data import Synthetic, make_spec
from hourglass_pose_estimation_torch.models import HourglassNet
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.runner import (
    Trainer, checkpoint, init_state, make_optimizer, make_train_step)

torch.set_num_threads(1)

# remat against no remat, one train step of the same model on the same
# batch: the loss is the same computation (equal), the gradients come from
# the same operations run again on the same inputs (equal here on the CPU;
# held at 1e-6 relative L2 over all of them for another summation order)
TOL_REMAT_GRAD = 1e-6


def _state(seed=0, lr=2.5e-3):
    torch.manual_seed(seed)
    model = HourglassNet(num_stacks=1, num_classes=16, num_feats=16,
                         dtype=torch.float32)
    return init_state(model, make_optimizer(lr, [2], 0.1, 3))


def _stepped(state, seed=0):
    """(`state` after one train step on a synthetic batch: optimizer
    statistics filled, BN running averages moved, the step's metrics)."""
    ds = Synthetic(True, num_samples=4, inp_res=64, out_res=16)
    step = make_train_step(make_spec(ds), device_pipeline=True)
    return step(state, ds.canvas_batch(range(4), canvas=64), seed)


def _tensors(state):
    opt = state.optimizer.state_dict()['state']
    return ([t for t in state.model.state_dict().values()]
            + [t for st in opt.values() for t in st.values()])


def test_save_restore_round_trip_is_bit_exact(tmp_path):
    src, _ = _stepped(_state(0))
    path = tmp_path / 'checkpoint_3'
    checkpoint.save(str(path), src, epoch=3, best_acc=0.625)
    assert sorted(p.name for p in tmp_path.iterdir()) == ['checkpoint_3']   # no temp left
    dst = _state(1)
    out = checkpoint.restore(str(path), dst)
    assert out['epoch'] == 3 and out['best_acc'] == 0.625
    assert out['state'].step == src.step == 1
    a, b = _tensors(src), _tensors(out['state'])
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    params = checkpoint.restore_params(str(path))
    assert all(torch.equal(v, src.model.state_dict()[k]) for k, v in params.items())


def test_optimizer_layout_fallback_keeps_params_and_step(tmp_path, capsys):
    src, _ = _stepped(_state(0))
    path = tmp_path / 'ckpt'
    checkpoint.save(str(path), src, epoch=5, best_acc=0.5)
    dst = _state(1)
    params = list(dst.model.parameters())
    # another layout: the same parameters in two groups
    dst.optimizer = torch.optim.RMSprop([{'params': params[:3]}, {'params': params[3:]}],
                                        lr=1e-3)
    out = checkpoint.restore(str(path), dst)
    assert 'optimizer layout differs' in capsys.readouterr().out
    assert out['epoch'] == 5 and out['state'].step == 1
    for k, v in src.model.state_dict().items():
        assert torch.equal(v, out['state'].model.state_dict()[k]), k
    fresh = out['state'].optimizer
    assert len(fresh.param_groups) == 1 and not fresh.state
    # state tensors of other shapes are another layout too
    bad = _state(2)
    sd = torch.load(path, weights_only=True)
    first = next(iter(sd['optimizer']['state']))
    sd['optimizer']['state'][first]['square_avg'] = torch.zeros(3)
    torch.save(sd, tmp_path / 'shapes')
    checkpoint.restore(str(tmp_path / 'shapes'), bad)
    assert 'optimizer layout differs' in capsys.readouterr().out


def test_broken_checkpoint_raises_its_own_error(tmp_path):
    path = tmp_path / 'ckpt'
    checkpoint.save(str(path), _state(0), epoch=1, best_acc=0.0)
    data = path.read_bytes()
    (tmp_path / 'cut').write_bytes(data[:len(data) // 2])
    (tmp_path / 'junk').write_bytes(b'not a checkpoint')
    for name in ('cut', 'junk', 'absent'):
        with pytest.raises(Exception) as err:
            checkpoint.restore(str(tmp_path / name), _state(1))
        assert 'optimizer layout' not in str(err.value)
    # a model state of another shape is no optimizer-layout case either
    other = init_state(HourglassNet(num_stacks=1, num_classes=5, num_feats=16),
                       make_optimizer(1e-3, [], 0.1, 1))
    with pytest.raises(RuntimeError, match='size mismatch'):
        checkpoint.restore(str(path), other)


def _cfg(tmp_path, **extra):
    raw = {'DATASET': {'name': 'synthetic', 'inp_res': 64, 'out_res': 16,
                       'num_samples': 8, 'canvas_mode': 'image'},
           'MODEL': {'num_stacks': 1},
           'TRAIN': {'epochs': 3, 'train_batch': 4, 'val_batch': 4,
                     'precision': 'f32', 'schedule': [4, 6], 'gamma': 0.1},
           'COMMON': {'checkpoint_dir': str(tmp_path), 'snapshot': 2}}
    for k, v in extra.items():
        raw[k] = {**raw[k], **v}
    return load_config(raw=raw)


def test_absent_resume_path_starts_fresh(tmp_path, capsys):
    missing = tmp_path / 'ckpts' / 'checkpoint_9'
    t = Trainer(_cfg(tmp_path, COMMON={'resume': str(missing)}), device='cpu')
    assert t.start_epoch == 0 and t.state.step == 0 and t.best_acc == 0.0
    assert 'starting fresh' in capsys.readouterr().out


def test_lr_fast_forward_of_a_step0_checkpoint(tmp_path, capsys):
    """A checkpoint of epoch 5 that carries step 0 (an import with no
    optimizer history) resumes at step 5 * steps_per_epoch, so the learning
    rate is the decayed one of that step, not the base rate."""
    t = Trainer(_cfg(tmp_path), verbose=False, device='cpu')
    path = tmp_path / 'imported'
    checkpoint.save(str(path), t.state, epoch=5, best_acc=0.25)
    r = Trainer(_cfg(tmp_path, COMMON={'resume': str(path)}, TRAIN={'epochs': 8}),
                device='cpu')
    assert 'fast-forwarded the LR schedule to step 10' in capsys.readouterr().out
    assert r.steps_per_epoch == 2 and r.start_epoch == 5 and r.state.step == 10
    assert r.best_acc == 0.25
    assert r.state.tx.lr(r.state.step) == pytest.approx(2.5e-3 * 0.1)
    # a genuine snapshot (step > 0) is left as it is
    t.state.step = 7
    checkpoint.save(str(path), t.state, epoch=5, best_acc=0.25)
    assert Trainer(_cfg(tmp_path, COMMON={'resume': str(path)}), verbose=False,
                   device='cpu').state.step == 7


def test_snapshot_and_best_cadence(tmp_path):
    """Snapshots every COMMON.snapshot epochs; `best` rewritten whenever the
    val PCK improves, carrying that epoch and PCK."""
    t = Trainer(_cfg(tmp_path, TRAIN={'epochs': 5}), verbose=False, device='cpu')
    val = iter([(1.0, 0.1), (0.9, 0.05), (0.8, 0.3), (0.7, 0.2), (0.6, 0.3)])
    t._train_epoch = lambda epoch, rng: (1.0, 0.0, 0.0)
    t._evaluate = lambda: next(val)
    assert t.train() == 0.3
    ck = tmp_path / 'ckpts'
    assert sorted(p.name for p in ck.iterdir()) == ['best', 'checkpoint_2', 'checkpoint_4']
    load = lambda name: torch.load(ck / name, weights_only=True)
    assert (load('best')['epoch'], load('best')['best_acc']) == (3, 0.3)
    assert load('checkpoint_2')['best_acc'] == 0.1
    assert load('checkpoint_4')['best_acc'] == 0.3
    assert [h['epoch'] for h in t.history] == [1, 2, 3, 4, 5]


def test_remat_train_step_matches_plain_and_moves_stats_once():
    """One train step with each hourglass rematerialised against the same
    step without: the loss equal, the gradients equal (within
    TOL_REMAT_GRAD), and every running average moved once (equal to the
    plain step's, and not where a second update would put it)."""
    states = []
    for remat in (False, True):
        s = _state(3)
        s.model.remat = remat
        states.append(s)
    before = [m.running_mean.clone() for m in states[0].model.modules()
              if isinstance(m, BatchNorm)]
    grads, losses = [], []
    for s in states:
        s.optimizer.step = lambda: None                 # keep the gradients
        losses.append(float(_stepped(s, seed=4)[1]['loss']))
        grads.append([p.grad.clone() for p in s.model.parameters()])
    assert losses[0] == losses[1]
    a, b = (torch.cat([g.flatten() for g in gs]) for gs in grads)
    assert float((a - b).norm() / b.norm()) <= TOL_REMAT_GRAD
    stats = [[t.clone() for m in s.model.modules() if isinstance(m, BatchNorm)
              for t in (m.running_mean, m.running_var)] for s in states]
    assert len(stats[0]) == len(stats[1]) > 0
    for x, y in zip(*stats):
        assert torch.equal(x, y)
    after = [m.running_mean for m in states[1].model.modules() if isinstance(m, BatchNorm)]
    assert any(not torch.equal(x, y) for x, y in zip(before, after))
    assert all(m.update_stats for m in states[1].model.modules() if isinstance(m, BatchNorm))
