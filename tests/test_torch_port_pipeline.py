"""The port's pipeline parallelism (`parallel/pipeline.py`, the Trainer under
TRAIN.pipeline_parallel) against the JAX package's on the CPU. Four gloo
ranks, a (data 2 x pipe 2) layout, run as processes of their own
(tests/torch_port_pipeline_ranks.py, which imports no JAX), once for the
whole file, while JAX `make_pipeline_train_step` runs here on a (2, 2)
('data', 'pipe') mesh of the conftest's virtual devices, from the same
weights (JAX's `init_pipeline`, carried to the port by
`weights.load_jax_pipeline_variables`) and the same batches:
tests/test_pipeline_parallel.py's sizes (4 stacks, 4 joints, batch 8, 2
microbatches, 64^2, 64 features) and its three steps (eval mode, train
mode with depth-2 stacks and the two-pass variance, one update), all in
f64 and held at its f64 gate. Then the pipeline trainer CLI on the ranks against the
standard Trainer in one process. The split round trip and the Trainer's
refusals run in one process."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from hourglass_pose_estimation_tpu.models.hourglass import (
    HourglassNet as JaxNet, HourglassStack as JaxStack, HourglassStem as JaxStem)
from hourglass_pose_estimation_tpu.parallel import pipeline as jpl
from hourglass_pose_estimation_tpu.runner.train_state import make_optimizer as jax_optimizer

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch import train_and_evaluate
from hourglass_pose_estimation_torch.models import HourglassNet
from hourglass_pose_estimation_torch.parallel import Mesh, make_mesh
from hourglass_pose_estimation_torch.parallel.pipeline import (
    build_stage, init_pipeline, merge_hourglass_variables, split_hourglass_variables, stage_of)
from hourglass_pose_estimation_torch.runner import Trainer, make_optimizer
from hourglass_pose_estimation_torch.weights import load_jax_variables

import torch_port_pipeline_ranks as ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
TINY = str(REPO / 'configs' / 'train_synthetic_tiny.yaml')
# the ranks' whole run (startup, three steps, the trainer CLI twice)
RANKS_TIMEOUT_S = 600
# the loss and gradients of both the eval-mode and the train-mode step,
# in f64 here (torch_port_pipeline_ranks.MODES says why), relative to each
# leaf's largest value: tests/test_pipeline_parallel.py's f64 gate. Its
# f32 eval-mode gates (the loss at 1e-5 relative, the gradients at 5e-3
# relative and 1e-3 of each leaf's largest value) are what applies in f32
TOL_F64 = 1e-9
# the update's parameters and running statistics in f64 against JAX's,
# relative to each leaf's largest value, absolute below 1: read 9.6e-10 on
# the conv biases that feed a BatchNorm (0 at init, their gradients
# rounding noise, which RMSprop's first step divides by its eps), 8.2e-11
# on any other parameter and 1.3e-14 on the statistics; held at 4x
TOL_UPDATE = 4e-9
# PCK: the port's mean of f32 per-microbatch accuracies against JAX's
TOL_PCK = 1e-6
# the pipeline trainer against the standard Trainer in one process, both
# f32, from the same weights: a resume by the standard Trainer restores
# the parameters exactly; the one-process evaluator on the pipeline's
# checkpoint against the pipeline trainer's validation of it (the merged
# model, its rows over 4 ranks): read 0 (loss, relative) and equal PCK
TOL_EVALUATOR = 1e-6
LEAVES = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight', 'mean': 'running_mean',
          'var': 'running_var'}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _port_names(tree) -> dict:
    """A flax-named tree (of one module) as the port's names and layouts."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [k.key for k in path]
        arr = np.asarray(leaf, np.float64)
        if keys[-1] == 'kernel':
            arr = arr.transpose(3, 2, 0, 1)
        out['.'.join(keys[:-1] + [LEAVES[keys[-1]]])] = arr
    return out


def _stack(tree, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], tree)


def _as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _mesh():
    return JaxMesh(np.asarray(jax.devices()[:4]).reshape(ranks.DP, ranks.PP), ('data', 'pipe'))


def _batch(key, dtype):
    k1, k2, k3 = jax.random.split(key, 3)
    images = jax.random.normal(k1, (ranks.B, ranks.RES, ranks.RES, 3), jnp.float32)
    target = jax.nn.sigmoid(jax.random.normal(
        k2, (ranks.B, ranks.RES // 4, ranks.RES // 4, ranks.J), jnp.float32))
    tw = (jax.random.uniform(k3, (ranks.B, ranks.J)) > 0.2).astype(jnp.float32)
    return tuple(np.asarray(a, dtype) for a in (images, target, tw))


def _modules(mode):
    dtype, depth, fast = ranks.MODES[mode]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    return (JaxStem(num_feats=ranks.FEATS, dtype=jdt, bn_fast_variance=fast),
            JaxStack(num_feats=ranks.FEATS, num_blocks=1, num_classes=ranks.J, depth=depth,
                     dtype=jdt, out_dtype=jdt, bn_fast_variance=fast))


def _init(mode):
    """JAX's initial pipeline state for `mode`, cast to f64 as the JAX
    test casts its train-mode one, and the step's batch (call under x64)."""
    stem, stack = _modules(mode)
    tx = jax_optimizer(*ranks.LR, flat=False)
    state = jpl.init_pipeline(stem, stack, jax.random.PRNGKey(0), ranks.S, tx, inp_res=ranks.RES)
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    state = state.replace(stem_params=f64(state.stem_params), stem_stats=f64(state.stem_stats),
                          stacked_params=f64(state.stacked_params),
                          stacked_stats=f64(state.stacked_stats))
    images, target, tw = _batch(jax.random.PRNGKey(1), np.float64)
    # as the JAX test's train mode: the feedback of 4 stacks keeps the
    # losses O(1) this way
    return state, (images if mode == 'eval' else 0.05 * images, target, tw)


def _inputs(state, batch) -> dict:
    images, target, tw = batch
    return dict(stem=_as_torch({'params': state.stem_params, 'batch_stats': state.stem_stats}),
                stacked=_as_torch({'params': state.stacked_params,
                                   'batch_stats': state.stacked_stats}),
                images=torch.from_numpy(images), target=torch.from_numpy(target),
                tw=torch.from_numpy(tw))


def _jax_step(mode, state, batch, train, update):
    stem, stack = _modules(mode)
    step = jpl.make_pipeline_train_step(stem, stack, _mesh(), num_microbatches=ranks.M,
                                        train=train, update=update)
    # host copies: the step donates the state it is given
    new_state, metrics = step(jpl.shard_pipeline_state(jax.tree.map(np.array, state), _mesh()),
                              *batch)
    out = {'loss': float(metrics['loss']), 'acc': float(metrics['acc'])}
    if update:
        out['stem'] = {**_port_names(new_state.stem_params),
                       **_port_names(new_state.stem_stats)}
        out['stacks'] = [{**_port_names(_stack(new_state.stacked_params, i)),
                          **_port_names(_stack(new_state.stacked_stats, i))}
                         for i in range(ranks.S)]
    else:
        out['g_stem'] = _port_names(metrics['g_stem'])
        out['g_stack'] = [_port_names(_stack(metrics['g_stack'], i)) for i in range(ranks.S)]
    return out


def _spawn(work: Path):
    env = {k: v for k, v in os.environ.items() if k not in ('XLA_FLAGS', 'JAX_PLATFORMS')}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS='1', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(ranks.WORLD))
    procs = []
    for r in range(ranks.WORLD):
        # output to files: a full pipe would block a rank inside a collective
        log = open(work / f'rank{r}.log', 'wb')
        procs.append((subprocess.Popen(
            [sys.executable, str(HERE / 'torch_port_pipeline_ranks.py'), str(work)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, work: Path) -> None:
    """Wait for every rank; the first to fail (or the time limit) stops
    them all."""
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            if any(p.poll() not in (None, 0) for p, _ in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    logs = '\n'.join(f'--- rank {r} (exit {p.returncode})\n'
                     + (work / f'rank{r}.log').read_text(errors='replace')[-6000:]
                     for r, (p, _) in enumerate(procs))
    assert all(p.returncode == 0 for p, _ in procs), logs


def _trainer_cfg(work: Path, name: str, *extra):
    return tconfig.load_config(TINY, overrides=ranks.TRAINER_ARGS + [
        f'COMMON.checkpoint_dir={work}/{name}/{ranks.RUN_NAME}'] + list(extra))


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The ranks' outputs and JAX's steps, computed while they run."""
    work = tmp_path_factory.mktemp('pipeline_ranks')
    with jax.enable_x64(True):
        states = {mode: _init(mode) for mode in ('eval', 'f64')}
    torch.save({mode: _inputs(*sb) for mode, sb in states.items()}, work / 'inputs.pt')
    procs = _spawn(work)
    try:
        with jax.enable_x64(True):
            refs = {'eval': _jax_step('eval', *states['eval'], train=False, update=False)}
            refs['train'] = _jax_step('f64', *states['f64'], train=True, update=False)
            refs['update'] = _jax_step('f64', *states['f64'], train=True, update=True)
        # the standard Trainer's initial weights from the same config and seed
        one = Trainer(_trainer_cfg(work, 'one', 'TRAIN.pipeline_parallel=1'), verbose=False,
                      device='cpu')
        refs['start'] = {k: v.clone() for k, v in one.model.state_dict().items()}
    finally:
        _wait(procs, work)
    outs = [torch.load(work / f'rank{r}.pt', weights_only=True) for r in range(ranks.WORLD)]
    return dict(work=work, refs=refs, ranks=outs)


def _rel(got, ref, floor: float = 1e-3) -> float:
    """Largest difference relative to the reference's largest value (at
    least `floor`)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), floor)


def _stage_stacks(rank_out: dict, entries: list):
    """(global stack index, entry) for each stack of the rank's stage."""
    p, k = rank_out['mesh'][3], ranks.S // ranks.PP
    return [(p * k + j, v) for j, v in enumerate(entries)]


def test_ranks_form_the_data_by_pipe_layout(run):
    """Rank = d * P + p, as JAX's devices.reshape(dp, pp); no rank imports
    JAX."""
    assert [got['mesh'] for got in run['ranks']] == [
        (ranks.DP, r // ranks.PP, ranks.PP, r % ranks.PP) for r in range(ranks.WORLD)]
    assert [got['forbidden_modules'] for got in run['ranks']] == [[]] * ranks.WORLD


def test_eval_mode_loss_and_grads_match_jax(run):
    """train=False (running averages, f64, depth-4 stacks): every rank's
    loss and PCK, the stem's gradients (summed over the pipe group,
    averaged over the data group: the same on every rank) and each stage's
    stacks' gradients against JAX's, within 1e-9 relative to each leaf's
    largest value. Read: 4.4e-15 of a leaf's largest gradient."""
    ref = run['refs']['eval']
    for rank_out in run['ranks']:
        got = rank_out['eval']
        assert abs(float(got['loss']) - ref['loss']) <= TOL_F64 * max(abs(ref['loss']), 1.0)
        assert float(got['acc']) == pytest.approx(ref['acc'], abs=TOL_PCK)
        pairs = [(got['g_stem'], ref['g_stem'])] + [
            (g, ref['g_stack'][i]) for i, g in _stage_stacks(rank_out, got['g_stack'])]
        for g, r in pairs:
            assert g.keys() == r.keys()
            for name, a in g.items():
                assert _rel(a, r[name]) <= TOL_F64, (name, _rel(a, r[name]))


def test_train_mode_f64_loss_and_grads_match_jax(run):
    """train=True in f64 (per-microbatch statistics, two-pass variance,
    depth-2 stacks): the loss and every gradient against JAX's within
    1e-9 relative (the JAX test's gate against its sequential oracle of
    the same microbatch slices). Read: 3.8e-12 (a gradient: conv1's bias,
    rounding noise that a BatchNorm cancels)."""
    ref = run['refs']['train']
    for rank_out in run['ranks']:
        got = rank_out['train']
        assert abs(float(got['loss']) - ref['loss']) <= TOL_F64 * max(abs(ref['loss']), 1.0)
        pairs = [(got['g_stem'], ref['g_stem'])] + [
            (g, ref['g_stack'][i]) for i, g in _stage_stacks(rank_out, got['g_stack'])]
        for g, r in pairs:
            assert g.keys() == r.keys()
            for name, a in g.items():
                assert _rel(a, r[name]) <= TOL_F64, (name, _rel(a, r[name]))


def test_update_step_matches_jax(run):
    """One train=True update in f64: the loss, PCK, and after it every
    parameter and running statistic (M = 2 momentum updates a stack, the
    stem's from stage 0 broadcast over the pipe group, all averaged over
    the data group) against JAX's, on every rank."""
    ref = run['refs']['update']
    for rank_out in run['ranks']:
        got = rank_out['update']
        assert abs(float(got['loss']) - ref['loss']) <= TOL_F64 * max(abs(ref['loss']), 1.0)
        assert float(got['acc']) == pytest.approx(ref['acc'], abs=TOL_PCK)
        pairs = [(got['stem'], ref['stem'])] + [
            (s, ref['stacks'][i]) for i, s in _stage_stacks(rank_out, got['stacks'])]
        for s, r in pairs:
            assert s.keys() == r.keys()
            for name, a in s.items():
                assert _rel(a, r[name], 1.0) <= TOL_UPDATE, (name, _rel(a, r[name], 1.0))


def test_pipeline_trainer_trains_and_checkpoints_the_standard_layout(run):
    """The pipeline trainer CLI on 4 ranks: it starts from the standard
    Trainer's initial weights (COMMON.seed, split), trains and validates
    (finite, the same numbers on every rank), and rank 0 alone writes
    checkpoint_1 in the standard HourglassNet layout with the optimizer
    state as {'stem', 'stack'}."""
    start = run['refs']['start']
    for got in run['ranks']:
        tr = got['trainer']
        assert tr['start'].keys() == start.keys()
        assert all(torch.equal(tr['start'][k], v) for k, v in start.items())
        assert tr['val'].shape == (2, 2) and torch.isfinite(tr['val']).all()
        assert torch.equal(tr['val'], run['ranks'][0]['trainer']['val'])
    writes = [got['trainer']['writes'] for got in run['ranks']]
    assert all(w == [] for w in writes[1:]) and 'checkpoint_1' in writes[0]
    ckpt = torch.load(run['work'] / 'straight' / ranks.RUN_NAME / 'ckpts' / 'checkpoint_1',
                      weights_only=True)
    assert ckpt['model'].keys() == start.keys() and (ckpt['step'], ckpt['epoch']) == (2, 1)
    assert set(ckpt['optimizer']) == {'stem', 'stack'}
    # every parameter of the 2 stacks, the last one's feedback convs included
    n_stack = sum(1 for _ in build_stage(2, make_mesh(0, 1, 'cpu'), 'cpu', num_classes=16)[1][0]
                  .parameters())
    assert len(ckpt['optimizer']['stack']['state']) == 2 * n_stack


def test_pipeline_checkpoint_resumes_both_layouts(run, tmp_path):
    """checkpoint_1 resumed by the pipeline trainer on the 4 ranks: every
    tensor (parameters, statistics, both optimizer states, the step)
    exactly the file's, and its epoch 2 validated; resumed by the standard
    Trainer in one process: the parameters and statistics exactly the
    file's, with a fresh optimizer."""
    for got in run['ranks']:
        assert got['trainer']['restored_exactly'] == [True]
    ckpt = run['work'] / 'straight' / ranks.RUN_NAME / 'ckpts' / 'checkpoint_1'
    saved = torch.load(ckpt, weights_only=True)
    one = Trainer(_trainer_cfg(tmp_path, 'one', 'TRAIN.pipeline_parallel=1',
                               f'COMMON.resume={ckpt}'), verbose=False, device='cpu')
    assert one.start_epoch == 1 and one.state.step == saved['step']
    assert all(torch.equal(v, saved['model'][k]) for k, v in one.model.state_dict().items())
    assert one.state.optimizer.state_dict()['state'] == {}


def test_evaluate_only_reads_the_pipeline_checkpoint(run, tmp_path, capsys):
    """`evaluate_only` in one process on the pipeline's checkpoint_1 reads
    the (loss, PCK) that the pipeline trainer's validation of those weights
    printed (the merged model; its rows over the 4 ranks)."""
    ckpt = run['work'] / 'straight' / ranks.RUN_NAME / 'ckpts' / 'checkpoint_1'
    assert train_and_evaluate.main([TINY] + ranks.TRAINER_ARGS + [
        'COMMON.evaluate_only=true', f'COMMON.resume={ckpt}',
        f'COMMON.checkpoint_dir={tmp_path}', '--device', 'cpu']) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('loss ')][-1]
    loss, acc = float(line.split()[1]), float(line.split()[4])
    val_loss, val_acc = run['ranks'][0]['trainer']['val'][0].tolist()
    assert loss == pytest.approx(val_loss, rel=TOL_EVALUATOR, abs=1e-5)
    assert acc == pytest.approx(val_acc, abs=1e-4)


def test_split_round_trip_and_forward_match_jax():
    """A HourglassNet state_dict splits into the stem's and each stack's (the
    last one's feedback convs zero-filled) and merges back to itself; the
    stem and the stacks in sequence give HourglassNet's forward, and the
    JAX model's on the same weights (JAX test :220)."""
    net = JaxNet(num_stacks=2, num_blocks=1, num_classes=ranks.J, num_feats=ranks.FEATS,
                 dtype=jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, ranks.RES, ranks.RES, 3)))
    variables = net.init(jax.random.PRNGKey(4), x, train=False)
    ref = np.asarray(net.apply(variables, x, train=False))
    model = load_jax_variables(HourglassNet(num_stacks=2, num_classes=ranks.J,
                                            num_feats=ranks.FEATS, dtype=torch.float32),
                               jax.tree.map(np.asarray, variables)).to(
                                   memory_format=torch.channels_last)
    sd = model.state_dict()
    stem_sd, stack_sds = split_hourglass_variables(sd, 2)
    assert not any(t.any() for k, t in stack_sds[1].items() if k.split('.')[0] in (
        'fc_back', 'score_back'))
    merged = merge_hourglass_variables(stem_sd, stack_sds, 2)
    assert merged.keys() == sd.keys() and all(merged[k] is v for k, v in sd.items())
    stem, stacks = build_stage(2, make_mesh(0, 1, 'cpu'), 'cpu', num_feats=ranks.FEATS,
                               num_classes=ranks.J, dtype=torch.float32)
    stem.load_state_dict(stem_sd)
    for s, s_sd in zip(stacks, stack_sds):
        s.load_state_dict(s_sd)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        h, outs = stem(xt), []
        for s in stacks:
            score, h = s(h)
            outs.append(score)
        got = torch.stack(outs)
        assert torch.equal(got, model(xt))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_init_pipeline_draws_one_model_for_every_stage():
    """`init_pipeline` from one seeded generator: every stage holds the same
    stem, and stage p the stacks p*k .. p*k + k - 1 of the one model that a
    single stage holding every stack draws; the global generator is left
    as it was."""
    kw = dict(num_feats=16, num_classes=ranks.J, dtype=torch.float32)
    tx = make_optimizer(*ranks.LR)
    init = lambda mesh: init_pipeline(4, tx, mesh, torch.Generator().manual_seed(5), **kw)
    before = torch.random.get_rng_state()
    whole = init(make_mesh(0, 1, 'cpu'))
    assert torch.equal(torch.random.get_rng_state(), before)
    for stage in range(2):
        got = init(Mesh(world=1, rank=0, device=torch.device('cpu'), pipe=2, stage=stage))
        assert len(got.stacks) == 2 and got.first_stack == 2 * stage
        same = lambda a, b: all(torch.equal(v, b.state_dict()[k])
                                for k, v in a.state_dict().items())
        assert same(got.stem, whole.stem)
        assert all(same(s, whole.stacks[2 * stage + j]) for j, s in enumerate(got.stacks))


def test_stage_of_holds_the_models_own_modules():
    """`stage_of` (what the pipeline Trainer trains): each stage's stem and
    stacks are the HourglassNet's own modules, no copy; the last stack's
    feedback convs are new and zero, drawn from no generator; the stem and
    the stacks in sequence give the net's forward."""
    torch.manual_seed(0)
    net = HourglassNet(num_stacks=4, num_classes=ranks.J, num_feats=16, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, ranks.RES, ranks.RES, 3)).astype(np.float32))
    before = torch.random.get_rng_state()
    stages = [stage_of(net, Mesh(world=1, rank=0, device=torch.device('cpu'), pipe=2,
                                 stage=p)) for p in range(2)]
    assert torch.equal(torch.random.get_rng_state(), before)
    own = {id(t) for t in net.parameters()}
    last = stages[1][1][1]
    for stem, stacks in stages:
        assert [id(t) for t in stem.parameters()] == [
            id(t) for n, t in net.named_parameters() if n.split('.')[0] in
            ('conv1', 'bn1', 'layer1', 'layer2', 'layer3')]
        for s in stacks:
            feedback = ({id(t) for t in (*last.fc_back.parameters(),
                                         *last.score_back.parameters())}
                        if s is last else set())
            assert {id(t) for t in s.parameters()} - feedback <= own
    assert all(not t.any() for t in (*last.fc_back.parameters(), *last.score_back.parameters()))
    stem = stages[0][0]
    assert all(stage[0].conv1 is stem.conv1 for stage in stages)
    with torch.no_grad():
        h, outs = stem(x), []
        for s in stages[0][1] + stages[1][1]:
            score, h = s(h)
            outs.append(score)
        assert torch.equal(torch.stack(outs), net(x))


@pytest.mark.parametrize('override,match', [
    ('DATASET.device_pipeline=false', 'device_pipeline'),
    ('TRAIN.explicit_collectives=true', 'incompatible'),
    ('TRAIN.model_parallel=2', 'incompatible'),
    ('MODEL.arch=mspn', 'arch=hg'),
    ('MODEL.num_stacks=3', 'not divisible'),
    ('TRAIN.remat=true', 'remat'),
    ('TRAIN.freeze_bn_after_epoch=1', 'freeze_bn_after_epoch'),
    ('TRAIN.train_batch=6', 'data_parallel\\*microbatches = 4'),
    ('TRAIN.microbatches=2', 'needs 2 ranks')])
def test_pipeline_trainer_refusals(tmp_path, override, match):
    """What the pipeline Trainer does not take, with JAX's messages, before
    any dataset or model is built; in one process (no process group) a
    layout it can meet needs its ranks."""
    cfg = tconfig.load_config(TINY, overrides=[
        'MODEL.num_stacks=2', 'TRAIN.pipeline_parallel=2', 'TRAIN.microbatches=4',
        f'COMMON.checkpoint_dir={tmp_path}', override])
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, verbose=False, device='cpu')
