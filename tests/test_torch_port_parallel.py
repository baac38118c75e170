"""The port's data parallelism (`parallel/`: sync BatchNorm, the DDP step,
the explicit step, the Trainer on several ranks) against the JAX package's
on the CPU. Two gloo ranks run as processes of their own
(tests/torch_port_ranks.py, which imports no JAX), once for the whole
file; the JAX functions run here on a dp=2 mesh of the conftest's 8
virtual devices, and the port's one-process step on the global batch
beside them. A 1-stack hg at 64^2 with 16 features (narrow), a global
batch of 8 (4 a rank), in f64 throughout, parameters included: the order
of the ranks' sums differs from one process's, and in f32 the hourglass's
1x1 bottom level (its statistics over 8 values), the cancellation of the
ranks' f32 gradients in their average and RMSprop's sign-like first
update turn that into noise (test_torch_port_train_step.py). The draws are
JAX's, injected into the port's steps (the global batch's for the implicit
step, each rank's `fold_in` stream for the explicit one); the JAX steps
take the images the port's pipeline made from them (the pipeline itself is
held to JAX's in test_torch_port_train_data.py). The Trainer runs the
tiny synthetic config in f32, 1 step an epoch."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from hourglass_pose_estimation_tpu.data.pipeline import (
    sample_augmentations as jax_sample)
from hourglass_pose_estimation_tpu.data import Synthetic as JaxSynthetic
from hourglass_pose_estimation_tpu.data import make_spec as jax_make_spec
from hourglass_pose_estimation_tpu.models import HourglassNet as JaxNet
from hourglass_pose_estimation_tpu.parallel import (
    batch_sharding, make_mesh as jax_make_mesh, replicated_sharding)
from hourglass_pose_estimation_tpu.parallel import shard_map_step as jsms
from hourglass_pose_estimation_tpu.runner import train_state as jts

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch.data import (
    Synthetic, augment_batch, make_spec, to_device)
from hourglass_pose_estimation_torch.models import HourglassNet, get_model
from hourglass_pose_estimation_torch.models.norm import BatchNorm, sync_batch_norm
from hourglass_pose_estimation_torch.parallel import (
    make_mesh, maybe_initialize_distributed)
from hourglass_pose_estimation_torch.parallel.multihost import ENV
from hourglass_pose_estimation_torch.runner import Trainer
from hourglass_pose_estimation_torch.runner import train_state as tts
from hourglass_pose_estimation_torch.weights import to_jax_variables

import torch_port_ranks as ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# the ranks' whole run (startup, every scenario, the trainer CLI twice)
RANKS_TIMEOUT_S = 600
# tolerances (`_rel`), each about 4x its reading; see each test
TOL_SYNC_BN = 5e-12
TOL_ONE_PROCESS = 2e-10
TOL_JAX_IMPLICIT = 1e-9
TOL_JAX_EXPLICIT = {True: 3e-9, False: 1.6e-7}
# the implicit step with sampled statistics, against one process and JAX
TOL_SAMPLED = 7e-9
# the port's step reports PCK in f32, the JAX step under x64 in f64
TOL_PCK = 1e-7
# the trainers, f32 (see test_trainer_on_two_ranks_matches_one_process)
TOL_TRAINER_GRAD = 1.5e-2
TOL_TRAINER_MOVES = 8e-2
TOL_TRAINER_STATS = 1.2e-5
TOL_TRAINER_LOSS = 5e-4
# flax leaf -> the port's tensor name and layout (weights.py, kept in f64)
LEAVES = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight', 'mean': 'running_mean',
          'var': 'running_var'}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rel(a, b) -> float:
    """Largest difference relative to the reference's largest value, or
    absolute where that is below 1 (the conv biases that feed a BatchNorm
    get gradients of rounding noise and stay near 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _port_state(variables) -> dict:
    """A flax-named {'params', 'batch_stats'} tree as the port's state_dict
    names, in f64 (`load_jax_variables` keeps the port's f32)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [k.key for k in path][1:]
        arr = np.asarray(leaf, np.float64)
        if keys[-1] == 'kernel':
            arr = arr.transpose(3, 2, 0, 1)
        out['.'.join(keys[:-1] + [LEAVES[keys[-1]]])] = torch.from_numpy(np.array(arr))
    return out


def _shard(tree, device):
    """One device's copy of each leaf of a replicated tree (under
    check_rep=False the copies of per-shard values differ)."""
    return jax.tree.map(lambda a: np.asarray(
        next(s.data for s in a.addressable_shards if s.device == device)), tree)


def _inputs(rng):
    """The ranks' inputs and what the references need."""
    torch.manual_seed(0)       # the port's init, carried to JAX under the flax names
    variables = jax.tree.map(lambda a: a.astype(np.float64),
                             to_jax_variables(HourglassNet(**ranks.MODEL_KW)))
    ds = Synthetic(True, **ranks.DS_KW)
    raw = ds.canvas_batch(range(ranks.BATCH), canvas=64)
    spec = make_spec(ds)
    key = jax.random.PRNGKey(ranks.SEED)
    kw = dict(scale_factor=spec.scale_factor, rot_factor=spec.rot_factor, train=True)
    as_torch = lambda d: tuple(torch.from_numpy(np.array(v)) for v in d)
    draws_global = [as_torch(jax_sample(jax.random.fold_in(key, s), jnp.asarray(raw['scale']), **kw))
                    for s in range(ranks.STEPS)]
    draws_rank = [[as_torch(jax_sample(jax.random.fold_in(jax.random.fold_in(key, r), s),
                                       jnp.asarray(raw['scale'][ranks.rows(r)]), **kw))
                   for s in range(ranks.STEPS)] for r in range(ranks.WORLD)]
    # heterogeneous rows: each sample at its own scale, so the ranks' means
    # differ (where an average of per-rank variances would be biased low)
    x = rng.uniform(size=(ranks.BATCH, 64, 64, 3)) * (0.2 + np.arange(ranks.BATCH) / 4.0)[:, None, None, None]
    ct = rng.normal(size=(1, ranks.BATCH, 16, 16, 16))
    return dict(state_dict=_port_state(variables), x=torch.from_numpy(x),
                ct=torch.from_numpy(ct), raw={k: torch.from_numpy(np.array(v)) for k, v in raw.items()},
                draws_global=draws_global, draws_rank=draws_rank), variables, spec


def _staged(inp, spec, draws, rows=slice(None)):
    data = augment_batch(to_device({k: v[rows] for k, v in inp['raw'].items()}, 'cpu'),
                         draws, spec, True)
    return {k: data[k].numpy() for k in ('image', 'target', 'target_weight')}


def _jax_sync_bn(inp, variables):
    """HourglassNet(bn_axis_name='data') under shard_map on dp=2: outputs,
    statistics, the input gradient and each shard's parameter gradients of
    sum(outs * ct)."""
    mesh = jax_make_mesh(ranks.WORLD, 1)
    with jax.enable_x64(True):
        model = JaxNet(dtype=jnp.float64, out_dtype=jnp.float64, bn_axis_name='data',
                       **ranks.MODEL_KW)

        def local(v, xs, cts):
            def f(params, xs):
                outs, mut = model.apply({'params': params, 'batch_stats': v['batch_stats']},
                                        xs, train=True, mutable=['batch_stats'])
                return jnp.sum(outs * cts), (outs, mut['batch_stats'])
            (_, (outs, stats)), (gp, gx) = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(v['params'], xs)
            return outs, stats, gx, jax.tree.map(lambda g: g[None], gp)

        fn = shard_map(local, mesh=mesh, in_specs=(P(), P('data'), P(None, 'data')),
                       out_specs=(P(None, 'data'), P(), P('data'), P('data')), check_rep=False)
        outs, stats, gx, gp = jax.jit(fn)(variables, inp['x'].numpy(), inp['ct'].numpy())
        return dict(outs=np.asarray(outs), dx=np.asarray(gx),
                    state=_port_state({'params': variables['params'], 'batch_stats': stats}),
                    grads=[_port_state({'params': jax.tree.map(lambda g: np.asarray(g)[r], gp),
                                        'batch_stats': variables['batch_stats']})
                           for r in range(ranks.WORLD)])


def _jax_steps(variables, jspec, step, staged, sync_axis=None, stat_samples=0):
    """`step` (jitted, on dp=2) for each staged batch -> per-step (loss,
    acc), the parameters and each shard's statistics as state_dicts."""
    mesh = jax_make_mesh(ranks.WORLD, 1)
    with jax.enable_x64(True):
        model = JaxNet(dtype=jnp.float64, out_dtype=jnp.float64, bn_axis_name=sync_axis,
                       bn_stat_samples=stat_samples, **ranks.MODEL_KW)
        state = jax.device_put(jts.TrainState.create(
            apply_fn=model.apply, params=variables['params'],
            batch_stats=variables['batch_stats'], tx=jts.make_optimizer(*ranks.LR)),
            replicated_sharding(mesh))
        metrics = []
        for batch in staged:
            batch = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
            state, m = step(state, batch, jax.random.PRNGKey(ranks.SEED))
            metrics.append([float(m['loss']), float(m['acc'])])
        params = jax.tree.map(np.asarray, state.params)
        return dict(metrics=np.array(metrics), states=[
            _port_state({'params': params, 'batch_stats': _shard(state.batch_stats, d)})
            for d in mesh.devices.flat])


def _port_one_process(inp, spec, stat_samples=0):
    """The port's step in one process on the global batch, JAX's global
    draws injected."""
    model = ranks.model_f64(inp['state_dict'], stat_samples=stat_samples)
    state = tts.init_state(model, tts.make_optimizer(*ranks.LR))
    step = tts.make_train_step(spec)
    draws = iter(inp['draws_global'])
    saved, tts.sample_augmentations = tts.sample_augmentations, lambda g, s, **kw: next(draws)
    try:
        metrics = [[float(v) for v in step(state, inp['raw'], ranks.SEED)[1].values()]
                   for _ in range(ranks.STEPS)]
    finally:
        tts.sample_augmentations = saved
    return dict(metrics=np.array(metrics), state=model.state_dict())


def _spawn(work: Path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ('XLA_FLAGS', 'JAX_PLATFORMS')}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS='1', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(port), WORLD_SIZE=str(ranks.WORLD))
    procs = []
    for r in range(ranks.WORLD):
        # output to files: a full pipe would block a rank inside a collective
        log = open(work / f'rank{r}.log', 'wb')
        procs.append((subprocess.Popen(
            [sys.executable, str(HERE / 'torch_port_ranks.py'), str(work)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, work: Path) -> None:
    """Wait for every rank; the first to fail (or the time limit) stops
    them all."""
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [p for p, _ in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
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


@pytest.fixture(scope='module')
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope='module')
def run(tmp_path_factory, rng):
    """The ranks' outputs and the references, computed while they run."""
    work = tmp_path_factory.mktemp('ranks')
    inp, variables, spec = _inputs(rng)
    torch.save(inp, work / 'inputs.pt')
    procs = _spawn(work)
    try:
        jspec = jax_make_spec(JaxSynthetic(True, **ranks.DS_KW))
        refs = dict(sync_bn=_jax_sync_bn(inp, variables), one=_port_one_process(inp, spec),
                    one_k=_port_one_process(inp, spec, ranks.STEP_STAT_SAMPLES))
        staged = [_staged(inp, spec, d) for d in inp['draws_global']]
        refs['implicit'] = _jax_steps(
            variables, jspec, jts.make_train_step(jspec, device_pipeline=False), staged)
        refs['implicit_k'] = _jax_steps(
            variables, jspec, jts.make_train_step(jspec, device_pipeline=False), staged,
            stat_samples=ranks.STEP_STAT_SAMPLES)
        explicit = [{k: np.concatenate([_staged(inp, spec, inp['draws_rank'][r][s], ranks.rows(r))[k]
                                        for r in range(ranks.WORLD)])
                     for k in ('image', 'target', 'target_weight')} for s in range(ranks.STEPS)]
        with pytest.MonkeyPatch.context() as mp:
            # the JAX explicit step augments in its shard_map; hand it the
            # port's images of the same draws instead
            mp.setattr(jsms, 'augment_batch', lambda batch, rng, spec, train: batch)
            for sync in (True, False):
                refs[f'explicit_sync{int(sync)}'] = _jax_steps(
                    variables, jspec, jsms.make_shard_map_train_step(
                        jspec, jax_make_mesh(ranks.WORLD, 1), sync_bn=sync),
                    explicit, 'data' if sync else None)
        cfg = tconfig.load_config(str(REPO / 'configs' / 'train_synthetic_tiny.yaml'), overrides=(
            ranks.TRAINER_ARGS + ['TRAIN.epochs=1', f'COMMON.checkpoint_dir={work}/one']))
        trainer = Trainer(cfg, verbose=False, device='cpu')
        start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        trainer.train()
        refs['trainer'] = dict(history=trainer.history, start=start,
                               ckpt=work / 'one' / 'ckpts' / 'checkpoint_1')
    finally:
        _wait(procs, work)
    outs = [torch.load(work / f'rank{r}.pt', weights_only=True) for r in range(ranks.WORLD)]
    # one process resumed from the ranks' checkpoint_1 to epoch 2
    cfg = tconfig.load_config(str(REPO / 'configs' / 'train_synthetic_tiny.yaml'), overrides=(
        ranks.TRAINER_ARGS + ['TRAIN.epochs=2', f'COMMON.checkpoint_dir={work}/one_resumed',
                              f'COMMON.resume={_ckpts(work, "straight") / "checkpoint_1"}']))
    trainer = Trainer(cfg, verbose=False, device='cpu')
    trainer.train()
    refs['resumed'] = dict(history=trainer.history,
                           ckpt=work / 'one_resumed' / 'ckpts' / 'checkpoint_2')
    return dict(work=work, inp=inp, refs=refs, ranks=outs)


def _close_metrics(got, ref, tol):
    """Per-step (loss, PCK) rows."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=tol)
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=0, atol=TOL_PCK)


def _close_states(got, ref, tol, what):
    assert got.keys() == ref.keys()
    for k, v in got.items():
        assert _rel(v, ref[k]) <= tol, (what, k, _rel(v, ref[k]))


def test_sync_bn_matches_jax_bn_axis_name_under_shard_map(run):
    """Each rank's train-mode outputs, statistics, input gradient and
    parameter gradients against JAX's shard on heterogeneous rows, and the
    ranks together against one process on the whole batch (the parameter
    gradients' sum: the transpose of the statistics' pmean carries every
    rank's cotangent to every rank). Read: 1.1e-12 at most (the gradients),
    held at 5e-12."""
    ref = run['refs']['sync_bn']
    model = ranks.model_f64(run['inp']['state_dict'])
    x = run['inp']['x'].clone().requires_grad_(True)
    outs = model(x, train=True)
    (outs * run['inp']['ct']).sum().backward()
    for r, got in enumerate(run['ranks']):
        got = got['sync_bn']
        rows = ranks.rows(r)
        assert _rel(got['outs'], ref['outs'][:, rows]) <= TOL_SYNC_BN
        assert _rel(got['dx'], ref['dx'][rows]) <= TOL_SYNC_BN
        assert _rel(got['outs'], outs.detach()[:, rows]) <= TOL_SYNC_BN
        assert _rel(got['dx'], x.grad[rows]) <= TOL_SYNC_BN
        _close_states(got['state'], ref['state'], TOL_SYNC_BN, f'rank {r} state')
        _close_states(got['state'], model.state_dict(), TOL_SYNC_BN, f'rank {r} vs one process')
        grads = {k: v for k, v in ref['grads'][r].items() if 'running' not in k}
        _close_states(got['grads'], grads, TOL_SYNC_BN, f'rank {r} grads')
    for name, p in model.named_parameters():
        total = sum(got['sync_bn']['grads'][name] for got in run['ranks'])
        assert _rel(total, p.grad) <= TOL_SYNC_BN, name


@pytest.mark.parametrize('path,k', ranks.STAT_SAMPLE_CASES)
def test_sync_bn_stat_samples_takes_each_ranks_first_k(run, path, k):
    """stat_samples=k with sync, on each path's rows: the explicit path
    (JAX's shard_map, where each shard slices its own batch) takes each
    rank's first k rows, then the mean over the ranks; the implicit path
    (JAX's jit over a sharded batch, which slices the global batch) takes
    the global batch's first k, within rank 0's rows (k=2) or across both
    ranks' (k=6). Both ranks' running averages equal one process's
    BatchNorm over those rows. (Until the implicit path's repair this test
    held the explicit rule on both paths.)"""
    x = run['inp']['x'].permute(0, 3, 1, 2)
    bn = BatchNorm(3).double()
    if path == 'explicit':
        bn(torch.cat([x[ranks.rows(r)][:k] for r in range(ranks.WORLD)]), train=True)
    else:
        bn(x[:k], train=True)
    want = torch.stack([bn.running_mean, bn.running_var])
    for got in run['ranks']:
        assert _rel(got['sync_bn']['stat_samples'][f'{path}{k}'], want) <= TOL_SYNC_BN


@pytest.mark.parametrize('remat', [False, True])
def test_implicit_step_matches_one_process_and_jax(run, remat):
    """Two DDP steps on 2 ranks (each rank its slice of the global draws)
    against the port's step in one process on the global batch and against
    JAX make_train_step on dp=2: the loss and PCK of each step on both
    ranks, the parameters and running statistics after step 2. With remat
    the recomputed forward issues the statistics' all-reduces again inside
    the backward. Read: 5.3e-11 against one process (the statistics), held
    at 2e-10; 1.8e-10 against JAX (a conv weight), held at 1e-9."""
    one, jref = run['refs']['one'], run['refs']['implicit']
    for r, got in enumerate(run['ranks']):
        got = got[f'implicit_remat{int(remat)}']
        _close_metrics(got['metrics'], one['metrics'], TOL_ONE_PROCESS)
        _close_metrics(got['metrics'], jref['metrics'], TOL_JAX_IMPLICIT)
        _close_states(got['state'], one['state'], TOL_ONE_PROCESS, f'rank {r} vs one process')
        _close_states(got['state'], jref['states'][r], TOL_JAX_IMPLICIT, f'rank {r} vs JAX')


@pytest.mark.parametrize('remat', [False, True])
def test_implicit_step_with_stat_samples_takes_the_global_first_k(run, remat):
    """Two DDP steps on 2 ranks with TRAIN.bn_stat_samples=6 against JAX
    make_train_step on dp=2 with bn_stat_samples=6, whose jit slices the
    global batch's first 6 rows (rank 0's 4 and rank 1's first 2; each
    rank's own first 6 would be all 8 rows, the rule this path took
    before its repair), and against the port's one-process step on the
    global batch: the loss and PCK of each step on both ranks, the
    parameters and running statistics after step 2. The backward's
    recomputation (remat) issues the statistics' all-reduces again. Read
    (a parameter, after step 2): 1.7e-9 against JAX and 1.3e-9 against
    one process (the statistics of 6 rows, 1x1 at the hourglass's bottom),
    held at 7e-9."""
    one, jref = run['refs']['one_k'], run['refs']['implicit_k']
    for r, got in enumerate(run['ranks']):
        got = got[f'implicit_remat{int(remat)}_k{ranks.STEP_STAT_SAMPLES}']
        _close_metrics(got['metrics'], one['metrics'], TOL_SAMPLED)
        _close_metrics(got['metrics'], jref['metrics'], TOL_SAMPLED)
        _close_states(got['state'], one['state'], TOL_SAMPLED, f'rank {r} vs one process')
        _close_states(got['state'], jref['states'][r], TOL_SAMPLED, f'rank {r} vs JAX')


@pytest.mark.parametrize('sync_bn', [True, False])
def test_explicit_step_matches_jax_shard_map(run, sync_bn):
    """Two explicit steps on 2 ranks, each rank on the draws of JAX's
    fold_in(rng, rank) stream, against JAX make_shard_map_train_step on dp=2
    (the images the port made from those draws): the loss and PCK, the
    parameters after step 2, and each rank's running statistics against
    its shard's copy. sync_bn=True: global statistics, the same on both
    ranks; sync_bn=False: per-replica, each rank's its own (JAX returns each
    device its copy under check_rep=False; a read gives shard 0's, and the
    Trainer's checkpoint is rank 0's). Read (the parameters): 7.3e-10 with
    sync, held at 3e-9; 3.9e-8 without, held at 1.6e-7 (per-replica
    statistics of 4 samples, 1x1 at the hourglass's bottom)."""
    jref, tol = run['refs'][f'explicit_sync{int(sync_bn)}'], TOL_JAX_EXPLICIT[sync_bn]
    states = []
    for r, got in enumerate(run['ranks']):
        got = got[f'explicit_sync{int(sync_bn)}']
        _close_metrics(got['metrics'], jref['metrics'], tol)
        _close_states(got['state'], jref['states'][r], tol, f'rank {r}')
        states.append(got['state'])
    stats = [k for k in states[0] if 'running' in k]
    same = all(torch.equal(states[0][k], states[1][k]) for k in stats)
    assert same == sync_bn
    # the parameters are the same on both ranks either way
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0] if k not in stats)


def _ckpts(work: Path, run_dir: str) -> Path:
    return work / run_dir / 'synthetic_hg_s1_non-mobile_all' / 'ckpts'


def _same_training(got: dict, ref: dict, start: dict, history, val) -> None:
    """Two f32 checkpoints of the same epoch from the same `start`: the
    optimizer's E[g^2] (the gradients), the parameters' moves from `start`,
    the running statistics, and the epoch's validation."""
    assert (got['step'], got['epoch']) == (ref['step'], ref['epoch'])
    # |g| from E[g^2], relative L2 over the model: the conv biases that
    # feed a synced BatchNorm have per-rank gradients that cancel in the
    # ranks' f32 average, to rounding noise against one process's
    g = [(got['optimizer']['state'][i]['square_avg'].double().sqrt(),
          st['square_avg'].double().sqrt()) for i, st in ref['optimizer']['state'].items()]
    assert (sum(float((a - b).square().sum()) for a, b in g)
            / sum(float(b.square().sum()) for _, b in g)) ** 0.5 <= TOL_TRAINER_GRAD
    num = den = 0.0
    for k, v in ref['model'].items():
        if 'running' in k:
            assert _rel(got['model'][k], v) <= TOL_TRAINER_STATS, k
        else:
            move = v.double() - start[k].double()
            num += float((got['model'][k].double() - v.double()).square().sum())
            den += float(move.square().sum())
    assert (num / den) ** 0.5 <= TOL_TRAINER_MOVES
    np.testing.assert_allclose(val[0], history['val_loss'], rtol=TOL_TRAINER_LOSS)
    assert val[1] == pytest.approx(history['val_acc'], abs=TOL_PCK)


def test_trainer_on_two_ranks_matches_one_process(run):
    """The trainer CLI on 2 ranks (4 rows each) against the Trainer in one
    process, in f32: the checkpoint after epoch 1 (one step of 8) and the
    validation of that epoch (3 batches of 4, the last with 2 padded rows,
    all of them rank 1's), at lr 2.5e-5 (at the config's 2.5e-3 the
    running averages of one step leave the validation loss at 2e7). At
    64^2 the 1x1 bottom level's f32 statistics over 8 values move with
    the order of the sums, and RMSprop's first update, lr * 10 * sign(g),
    moves each parameter whose gradient is that small by +-lr * 10 at
    random. Read here and on the resume below (the larger of the two):
    |g| (from E[g^2]) 3.4e-3 relative L2, held at 1.5e-2; the parameters'
    moves 1.8e-2 relative L2, held at 8e-2; the statistics 2.9e-6, held at
    1.2e-5; the validation loss 1.2e-4 relative, held at 5e-4, and its PCK
    equal. Only rank 0 writes."""
    ref = torch.load(run['refs']['trainer']['ckpt'], weights_only=True)
    ckpts = _ckpts(run['work'], 'straight')
    got = torch.load(ckpts / 'checkpoint_1', weights_only=True)
    assert (got['step'], got['epoch']) == (1, 1)
    for got_rank in run['ranks']:
        _same_training(got, ref, run['refs']['trainer']['start'],
                       run['refs']['trainer']['history'][0], got_rank['trainer']['val'][0].tolist())
    writes = [got_rank['trainer']['writes'] for got_rank in run['ranks']]
    assert writes[1] == [] and {'checkpoint_1', 'checkpoint_2'} <= set(writes[0])
    assert {'checkpoint_1', 'checkpoint_2'} <= {p.name for p in ckpts.iterdir()} <= {
        'checkpoint_1', 'checkpoint_2', 'best'}


def test_trainer_resume_on_two_ranks_is_exact(run):
    """A resume on 2 ranks from the ranks' checkpoint_1: every rank holds
    exactly the file's parameters, statistics, optimizer state and step,
    and its epoch 2 (checkpoint_2, the validation) is one process's resumed
    from the same file, within the f32 tolerances above. (A resumed run
    draws its epoch seeds and its shuffle from the start of their streams,
    in one process as on several and as in the JAX package, so its epoch 2
    is not the uninterrupted run's.)"""
    for got in run['ranks']:
        assert got['trainer']['restored_exactly'] == [True]
    start = torch.load(_ckpts(run['work'], 'straight') / 'checkpoint_1', weights_only=True)['model']
    got = torch.load(_ckpts(run['work'], 'resumed') / 'checkpoint_2', weights_only=True)
    ref = torch.load(run['refs']['resumed']['ckpt'], weights_only=True)
    assert (got['step'], got['epoch']) == (2, 2)
    for got_rank in run['ranks']:
        val = got_rank['trainer']['val']      # straight: epochs 1, 2; resumed: epoch 2
        assert val.shape == (3, 2)
        _same_training(got, ref, start, run['refs']['resumed']['history'][0], val[2].tolist())


def test_ranks_import_no_jax(run):
    assert [got['forbidden_modules'] for got in run['ranks']] == [[], []]


def test_mesh_in_one_process():
    """No process group: one rank, no group; data_parallel=2 cannot be met
    (JAX's make_mesh asserts a mesh larger than the devices), nor can
    pipeline_parallel=2 or model_parallel=2 (the (data x model) layout on
    its ranks: test_torch_port_tensor_parallel.py)."""
    mesh = make_mesh(0, 1, 'cpu')
    assert (mesh.world, mesh.rank, mesh.device.type, mesh.group) == (1, 0, 'cpu', None)
    assert (mesh.shape, mesh.process_rank, mesh.size) == (
        {'data': 1, 'pipe': 1, 'model': 1}, 0, 1)
    assert make_mesh(1, 1, 'cpu').world == 1
    with pytest.raises(ValueError, match='world size 1'):
        make_mesh(2, 1, 'cpu')
    with pytest.raises(ValueError, match='needs 2 ranks'):
        make_mesh(0, 1, 'cpu', pipeline_parallel=2)
    with pytest.raises(ValueError, match='needs 2 ranks'):
        make_mesh(0, 2, 'cpu')


def test_initialize_distributed_is_a_no_op_or_raises(monkeypatch):
    """Without torchrun's environment: (0, 1) and no process group. With
    it, a rendezvous that cannot complete raises (no fallback to one
    process)."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed(device='cpu') == (0, 1)
    assert not dist.is_initialized()
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(RuntimeError, match='torchrun'):
        maybe_initialize_distributed(device='cpu')
    for k, v in dict(RANK='1', LOCAL_RANK='1', MASTER_ADDR='127.0.0.1',
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError):
        maybe_initialize_distributed(device='cpu', timeout=2, verbose=False)
    assert not dist.is_initialized()


def test_evaluate_only_on_two_ranks_matches_one_process(run, tmp_path, capsys):
    """COMMON.evaluate_only under the process group (as torchrun starts it)
    does what the JAX script does: every rank runs the single-device
    evaluator on the whole validation set, so each reads what one process
    reads on the ranks' checkpoint_1; rank 0 alone prints, the lines of one
    process."""
    from hourglass_pose_estimation_torch import train_and_evaluate
    ckpt = _ckpts(run['work'], 'straight') / 'checkpoint_1'
    assert train_and_evaluate.main([str(REPO / 'configs' / 'train_synthetic_tiny.yaml')]
                                   + ranks.TRAINER_ARGS + [
        'COMMON.evaluate_only=true', f'COMMON.resume={ckpt}', f'COMMON.checkpoint_dir={tmp_path}',
        '--device', 'cpu']) == 0
    printed = capsys.readouterr().out
    loss, acc = (float(v) for v in next(ln for ln in printed.splitlines()
                                        if ln.startswith('loss ')).split()[1::3])
    got = [r['evaluate_only'] for r in run['ranks']]
    for g in got:
        assert g['metrics'].shape == (1, 2)
        np.testing.assert_allclose(g['metrics'][0].numpy(), got[0]['metrics'][0].numpy(), rtol=0)
    assert got[0]['metrics'][0, 0].item() == pytest.approx(loss, abs=5e-6)
    assert got[0]['metrics'][0, 1].item() == pytest.approx(acc, abs=5e-5)
    assert got[0]['printed'].splitlines()[-2:] == printed.splitlines()[-2:]
    assert got[1]['printed'] == ''


def test_sync_bn_without_a_process_group_is_the_plain_forward():
    """axis_name='data' with no process group (or one rank): the forward
    and the running averages are the unsynced ones, bit for bit;
    fast_variance=False refuses the sync; MSPN's factory refuses
    bn_axis_name as JAX's does, while sync_batch_norm (the Trainer's
    switch) reaches every BatchNorm of any model."""
    torch.manual_seed(0)
    x = torch.rand(4, 8, 5, 5, dtype=torch.float64)
    plain, synced = BatchNorm(8), BatchNorm(8)
    synced.set_axis_name('data')
    assert torch.equal(plain(x, train=True), synced(x, train=True))
    assert torch.equal(plain.running_var, synced.running_var)
    two_pass = BatchNorm(8, fast_variance=False)
    two_pass.set_axis_name('data')
    with pytest.raises(ValueError, match='one-pass'):
        two_pass(x, train=True)
    with pytest.raises(ValueError, match="'data'"):
        plain.set_axis_name('batch')
    kw = dict(device='cpu', num_stacks=1, num_classes=4)
    with pytest.raises(ValueError, match='bn_axis_name'):
        get_model('mspn', bn_axis_name='data', **kw)
    mspn = sync_batch_norm(get_model('mspn', **kw))
    bns = [m for m in mspn.modules() if isinstance(m, BatchNorm)]
    assert bns and all(m.axis_name == 'data' for m in bns)


@pytest.mark.parametrize('override,error', [
    ('DATASET.device_pipeline=false', 'device_pipeline'),
    ('TRAIN.freeze_bn_after_epoch=1', 'implicit')])
def test_explicit_collectives_refusals(tmp_path, override, error):
    """The explicit step takes the device pipeline only, and no frozen-BN
    phase, as in JAX."""
    cfg = tconfig.load_config(str(REPO / 'configs' / 'train_synthetic_tiny.yaml'), overrides=[
        'TRAIN.explicit_collectives=true', override, f'COMMON.checkpoint_dir={tmp_path}'])
    with pytest.raises(ValueError, match=error):
        Trainer(cfg, verbose=False, device='cpu')
