"""The port's tensor parallelism (`parallel/mesh.py`'s (data x model) layout
and rule, `parallel/tensor_parallel.py`, the Trainer under
TRAIN.model_parallel) and its overlapped train step against the JAX
package's, on the CPU.

Four gloo ranks, a (data 2 x model 2) layout, run as processes of their own
(tests/torch_port_tp_ranks.py, which imports no JAX), once for the whole
file, while JAX `make_train_step` runs here on a (2, 2) ('data', 'model')
mesh of the conftest's virtual devices with its parameters, accumulators
and statistics placed by `shard_params` (tests/test_parallel.py:88, the JAX
Trainer's `_place_state`), and the port's unsharded step runs beside it:
tests/test_trainer_mesh.py's sizes (1 stack, 128 features so that the rule
shards, 64^2 -> 16^2, a global batch of 8), all in f64, the port's seeded
init carried to JAX under the flax names. Each transpose and sharded layer
alone, one MSPN step against the port's unsharded MSPN, and the Trainer's
oracles (tests/test_trainer_mesh.py:26,45,90) run on the same ranks. The
overlapped step runs in one process against JAX's
(tests/test_train.py:161), JAX's draws injected."""

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

from hourglass_pose_estimation_tpu.data import Synthetic as JaxSynthetic
from hourglass_pose_estimation_tpu.data import make_spec as jax_make_spec
from hourglass_pose_estimation_tpu.data.pipeline import sample_augmentations as jax_sample
from hourglass_pose_estimation_tpu.loss import heatmap_mse_loss as jax_loss
from hourglass_pose_estimation_tpu.models import HourglassNet as JaxNet
from hourglass_pose_estimation_tpu.parallel import (
    batch_sharding, make_mesh as jax_make_mesh, shard_params as jax_shard_params)
from hourglass_pose_estimation_tpu.runner import train_state as jts

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch import train_and_evaluate
from hourglass_pose_estimation_torch.data import Synthetic, augment_batch, make_spec, to_device
from hourglass_pose_estimation_torch.models import HourglassNet, mspn
from hourglass_pose_estimation_torch.parallel import (
    Mesh, param_sharding_rules, shard_params)
from hourglass_pose_estimation_torch.runner import Trainer
from hourglass_pose_estimation_torch.runner import train_state as tts
from hourglass_pose_estimation_torch.weights import load_jax_variables, to_jax_variables

import torch_port_tp_ranks as ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
TINY = str(REPO / 'configs' / 'train_synthetic_tiny.yaml')
# the ranks' whole run (startup, the layers, four steps, MSPN, the trainer
# CLI three times)
RANKS_TIMEOUT_S = 600
# f64 against JAX and against the port's unsharded step: the loss (relative
# to max(|loss|, 1)) and each gradient (relative to its leaf's largest
# value), test_torch_port_pipeline.py's gate
TOL_F64 = 1e-9
# the update's parameters and statistics, relative to each leaf's largest
# value, absolute below 1 (test_torch_port_pipeline.py's gate: the conv
# biases that feed a BatchNorm get gradients of rounding noise, which
# RMSprop's first step divides by its eps)
TOL_UPDATE = 4e-9
# the same under sampled statistics (6 of 8 rows): their gradients' noise
# is larger; JAX's own (2, 2) step against its unsharded one reads 5.5e-8
# there (layer1.conv2.bias), held at about 4x
TOL_SAMPLED_UPDATE = 2e-7
# the port reports PCK in f32
TOL_PCK = 1e-6
# MSPN in f64: its heads leave the model in f32, so its loss carries f32
# rounding: read 6.0e-8 relative to max(|loss|, 1), held at 4x; its
# gradients read 3.8e-12 of each leaf's largest, held at TOL_F64
TOL_MSPN_LOSS = 2.4e-7
# the overlapped step against JAX's (f32, JAX's draws, the port's warp):
# the first loss relative (read 9.3e-7, held at about 4x), and the
# trajectory at tests/test_train.py:161's gate
TOL_OVERLAP_FIRST = 4e-6
TOL_OVERLAP_TRAJECTORY = 0.05
# the overlapped runs: tests/test_train.py:161's data (Synthetic 64^2, 4
# batches of 8), a 1-stack model narrowed to 32 features (the step does not
# depend on the width; JAX compiles it faster). At the JAX test's rate
# (2.5e-3) RMSprop's first update, lr * 10 * sign(g), flips with the sign
# of each gradient that is rounding noise, so the two frameworks' f32
# trajectories part by 21% at step 4; at the flagship schedule's rate past
# both decays, 2.5e-5, they read 5.7e-4 apart at step 3
OVERLAP_DS = dict(num_samples=32, inp_res=64, out_res=16, sigma=1, scale_factor=0.25,
                  rot_factor=30)
OVERLAP_MODEL = dict(num_stacks=1, num_blocks=1, num_classes=16, num_feats=32)
OVERLAP_LR = (2.5e-5, [], 0.1, 4)
OVERLAP_KEY = 7
# evaluate_only in one process on the TP checkpoint against the TP
# trainer's validation of those weights (the replica, rows over 4 ranks)
TOL_EVALUATOR = 1e-6
LEAVES = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight', 'mean': 'running_mean',
          'var': 'running_var'}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _port_names(tree, arrays: bool = True) -> dict:
    """A flax-named tree of one collection as the port's names and layouts,
    in f64 (with `arrays`; else the leaves as they are)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [k.key for k in path]
        if arrays:
            leaf = np.asarray(leaf, np.float64)
            if keys[-1] == 'kernel':
                leaf = leaf.transpose(3, 2, 0, 1)
        out['.'.join(keys[:-1] + [LEAVES[keys[-1]]])] = leaf
    return out


def _rel(got, ref, floor: float = 1e-3) -> float:
    """Largest difference relative to the reference's largest value (at
    least `floor`)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), floor)


def _worst(got: dict, ref: dict, floor: float = 1e-3):
    assert got.keys() == ref.keys(), set(got) ^ set(ref)
    return max((_rel(v, ref[k], floor), k) for k, v in got.items())


def _inputs():
    """The port's seeded init as JAX variables (f64) and a seeded batch:
    rows at their own scales, so the data ranks' statistics differ."""
    torch.manual_seed(0)
    variables = jax.tree.map(lambda a: a.astype(np.float64),
                             to_jax_variables(HourglassNet(**ranks.MODEL_KW)))
    rng = np.random.RandomState(0)
    scale = (0.2 + np.arange(ranks.B) / 4.0)[:, None, None, None]
    batch = dict(image=rng.normal(size=(ranks.B, ranks.RES, ranks.RES, 3)) * scale,
                 target=rng.uniform(size=(ranks.B, ranks.RES // 4, ranks.RES // 4, ranks.J)),
                 target_weight=(rng.uniform(size=(ranks.B, ranks.J)) > 0.2).astype(np.float64))
    return variables, batch


def _jax_model(stat_samples=0):
    return JaxNet(dtype=jnp.float64, out_dtype=jnp.float64, bn_stat_samples=stat_samples,
                  **ranks.MODEL_KW)


def _jax_tp(variables, batch, stat_samples=0) -> dict:
    """JAX on a (2, 2) ('data', 'model') mesh, everything placed by
    `shard_params`: the loss and gradients of the train-mode forward, and
    `make_train_step`'s update (call under x64)."""
    mesh = jax_make_mesh(ranks.DP, ranks.TP, devices=jax.devices()[:ranks.WORLD])
    place = lambda tree: jax.tree.map(jax.device_put, tree, jax_shard_params(tree, mesh))
    model = _jax_model(stat_samples)
    tx = jts.make_optimizer(*ranks.LR, flat=False)
    params, stats = place(variables['params']), place(variables['batch_stats'])
    state = jts.TrainState.create(apply_fn=model.apply, params=params, batch_stats=stats, tx=tx)
    state = state.replace(opt_state=place(state.opt_state))
    sharded = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
    out = {'sharded': sorted(k for k, s in _port_names(jax_shard_params(
        variables['params'], mesh), arrays=False).items() if 'model' in str(s.spec))}
    if not stat_samples:
        def loss_fn(p):
            outs, _ = model.apply({'params': p, 'batch_stats': stats}, sharded['image'],
                                  train=True, mutable=['batch_stats'])
            return jax_loss(outs, sharded['target'], sharded['target_weight'])
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        out.update(grad_loss=float(loss), grads=_port_names(grads))
    new, m = jts.make_train_step(None, device_pipeline=False)(state, sharded,
                                                             jax.random.PRNGKey(0))
    out.update(loss=float(m['loss']), acc=float(m['acc']),
               after={**_port_names(new.params), **_port_names(new.batch_stats)})
    return out


def _port_one_process(variables, batch, freeze_bn=False, stat_samples=0) -> dict:
    """The port's unsharded step in one process on the global batch."""
    model = HourglassNet(dtype=torch.float64, out_dtype=torch.float64,
                         bn_stat_samples=stat_samples, **ranks.MODEL_KW).double()
    load_jax_variables(model.to(memory_format=torch.channels_last), variables)
    state = tts.init_state(model, tts.make_optimizer(*ranks.LR))
    step = tts.make_train_step(None, device_pipeline=False, freeze_bn=freeze_bn)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    return {'loss': float(m['loss']), 'acc': float(m['acc']),
            'grads': {n: p.grad.numpy() for n, p in model.named_parameters()},
            'after': {k: v.numpy() for k, v in model.state_dict().items()}}


def _mspn_one_process() -> dict:
    torch.manual_seed(0)
    model = mspn(device='cpu', num_stacks=1, num_classes=ranks.J, out_res=ranks.RES // 4,
                 dtype=torch.float64).double()
    state = tts.init_state(model, tts.make_optimizer(*ranks.LR))
    state, m = tts.make_train_step(None, device_pipeline=False)(state, ranks.mspn_batch(), 0)
    return {'loss': float(m['loss']), 'grads': {n: p.grad.numpy()
                                                for n, p in model.named_parameters()}}


def _spawn(work: Path):
    env = {k: v for k, v in os.environ.items() if k not in ('XLA_FLAGS', 'JAX_PLATFORMS')}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS='1', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(ranks.WORLD))
    procs = []
    for r in range(ranks.WORLD):
        # output to files: a full pipe would block a rank inside a collective
        log = open(work / f'rank{r}.log', 'wb')
        procs.append((subprocess.Popen(
            [sys.executable, str(HERE / 'torch_port_tp_ranks.py'), str(work)],
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
        f'COMMON.checkpoint_dir={work}/{name}'] + list(extra))


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The ranks' outputs and the references, computed while they run."""
    work = tmp_path_factory.mktemp('tp_ranks')
    variables, batch = _inputs()
    as_torch = lambda tree: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    torch.save(dict(variables=as_torch(variables),
                    **{k: torch.from_numpy(v) for k, v in batch.items()}), work / 'inputs.pt')
    # a checkpoint of one process without tensor parallelism, for the ranks
    # to resume under it
    Trainer(_trainer_cfg(work, 'one', 'TRAIN.model_parallel=1', 'TRAIN.epochs=1'),
            verbose=False, device='cpu').train()
    procs = _spawn(work)
    try:
        refs = {'one': _port_one_process(variables, batch),
                'one_frozen': _port_one_process(variables, batch, freeze_bn=True),
                'one_sampled': _port_one_process(variables, batch,
                                                 stat_samples=ranks.STAT_SAMPLES),
                'mspn': _mspn_one_process()}
        with jax.enable_x64(True):
            refs['jax'] = _jax_tp(variables, batch)
            refs['jax_sampled'] = _jax_tp(variables, batch, ranks.STAT_SAMPLES)
        _, jspec, jstate, _, raws = _overlap_setup()
        refs['overlapped'] = _jax_overlapped(jspec, jstate, raws)
    finally:
        _wait(procs, work)
    outs = [torch.load(work / f'rank{r}.pt', weights_only=True) for r in range(ranks.WORLD)]
    return dict(work=work, refs=refs, ranks=outs)


def _np(d: dict) -> dict:
    return {k: v.numpy() for k, v in d.items()}


def test_ranks_form_the_data_by_model_layout(run):
    """Rank = d * 2 + m, as JAX's devices.reshape(dp, tp); the data
    coordinates are `Mesh.world`/`rank`; no rank imports JAX."""
    assert [got['mesh'] for got in run['ranks']] == [
        (ranks.DP, r // ranks.TP, ranks.TP, r % ranks.TP, r, ranks.WORLD)
        for r in range(ranks.WORLD)]
    assert [got['forbidden_modules'] for got in run['ranks']] == [[]] * ranks.WORLD


def test_rule_shards_the_leaves_jax_shards():
    """`param_sharding_rules` in the torch layout shards exactly the leaves
    JAX's rule shards (conv weights on their output channels, and the
    vectors of 128 or more), on dim 0; `shard_params` takes each rank's
    rows."""
    torch.manual_seed(0)
    model = HourglassNet(**ranks.MODEL_KW)
    variables = to_jax_variables(model)
    jmesh = jax_make_mesh(ranks.DP, ranks.TP, devices=jax.devices()[:ranks.WORLD])
    jax_sharded = sorted(k for coll in ('params', 'batch_stats') for k, s in _port_names(
        jax_shard_params(variables[coll], jmesh), arrays=False).items() if 'model' in str(s.spec))
    sd = model.state_dict()
    meshes = [Mesh(world=1, rank=0, device=torch.device('cpu'), model=2, model_rank=m)
              for m in range(2)]
    ours = sorted(k for k, v in sd.items() if param_sharding_rules(v.shape, meshes[0]) == 0)
    assert ours == jax_sharded and len(ours) > 0
    assert all(param_sharding_rules(v.shape, Mesh(world=1, rank=0, device=torch.device('cpu')))
               is None for v in sd.values())
    halves = [shard_params(sd, mesh) for mesh in meshes]
    for k, v in sd.items():
        if k in ours:
            assert torch.equal(torch.cat([h[k] for h in halves]), v)
            assert halves[1][k].shape[0] == v.shape[0] // 2
        else:
            assert all(h[k] is v for h in halves)


def test_transposes_and_sharded_layers_alone(run):
    """Each autograd transpose and sharded layer on the model group, on
    every rank: the output gather's forward is the concatenation and its
    backward this rank's slice (not a reduce-scatter, which would count
    the replicated gradient twice); the sharded conv's input identity sums
    its gradient over the model group; a plain, a grouped (2 groups) and a
    depthwise ShardedConv and a ShardedBatchNorm (train and eval) give the
    unsharded layer's output, input gradient and their slice of its
    parameter gradients (f64; the convs' outputs read 0 apart, held at
    1e-12)."""
    inp = ranks.unit_inputs()
    for r, got in enumerate(run['ranks']):
        u, m = got['units'], r % ranks.TP
        y, gx = u['gather']
        base = torch.arange(24, dtype=torch.float64).view(2, 3, 4)
        assert torch.equal(y, torch.cat([base, base + 100], 1))
        gy = torch.arange(y.numel(), dtype=torch.float64).view(y.shape)
        assert torch.equal(gx, gy[:, 3 * m:3 * (m + 1)])
        assert torch.equal(u['sum_grad'], torch.full((3,), 5.0, dtype=torch.float64))
        rows = slice(4 * m, 4 * (m + 1))
        for groups, (w, b) in inp['convs'].items():
            conv = ranks.plain_conv(groups, w, b)
            x = inp['x'].clone().requires_grad_(True)
            ref = conv(x)
            ref.backward(inp['gy'])
            for a, e in zip(u[f'conv{groups}'], (ref.detach(), x.grad, conv.weight.grad[rows],
                                                 conv.bias.grad[rows])):
                assert torch.allclose(a, e, rtol=1e-12, atol=1e-12), groups
        bn = ranks.plain_bn(inp['bn'])
        x = inp['x'].clone().requires_grad_(True)
        ref = bn(x, train=True)
        ref.backward(inp['gy'])
        for a, e in zip(u['bn_train'], (ref.detach(), x.grad, bn.weight.grad[rows],
                                        bn.bias.grad[rows], bn.running_mean[rows],
                                        bn.running_var[rows])):
            assert torch.allclose(a, e, rtol=1e-12, atol=1e-12)
        assert torch.allclose(u['bn_eval'], bn(inp['x'], train=False), rtol=1e-12, atol=1e-12)


def test_sharded_blocks_take_the_standard_path(run):
    """`shard_model` closes the fused bottleneck of every block that holds a
    shard (the kernel needs every channel and the whole fold: at 128
    features every block's convs are sharded), and the standard replica
    keeps it open, so validation fuses."""
    for got in run['ranks']:
        before, sharded, standard = got['fusable']
        assert before > 0 and sharded == 0 and standard == before, got['fusable']


def test_tp_step_matches_jax_and_the_unsharded_step(run):
    """One train step on dp 2 x tp 2, f64: every rank's loss, its gradients
    (DDP's average over the data group, each shard gathered over the model
    group) and the parameters and statistics after the update, against
    JAX `make_train_step` and `value_and_grad` on a (2, 2) mesh with
    `shard_params` and against the port's unsharded step on the global
    batch. `load_jax_variables` with the mesh fills a sharded model with
    the Trainer's shards of the same weights."""
    jx, one = run['refs']['jax'], run['refs']['one']
    assert jx['sharded'], 'the JAX rule sharded nothing'
    assert abs(jx['grad_loss'] - jx['loss']) <= TOL_F64 * max(abs(jx['loss']), 1.0)
    for got in run['ranks']:
        t = got['train']
        assert t['jax_loader_same']
        for ref in (jx, one):
            assert abs(float(t['loss']) - ref['loss']) <= TOL_F64 * max(abs(ref['loss']), 1.0)
            assert float(t['acc']) == pytest.approx(ref['acc'], abs=TOL_PCK)
            assert _worst(_np(t['grads']), ref['grads'])[0] <= TOL_F64
            assert _worst(_np(t['after']), ref['after'], 1.0)[0] <= TOL_UPDATE


def test_replicated_parameters_stay_bit_equal_across_ranks(run):
    """After 3 steps every replicated tensor is bit-equal on the four ranks
    (each model rank computes its gradient from the same tensors; DDP
    averages over the data group), and every shard is equal across the data
    ranks of its model coordinate. The model ranks' replicated gradients
    were bit-equal before their average, in every step of the three runs
    (`replicated_spread` exactly 0: the ranks are deterministic in f64), so
    the average that keeps them one value hides no transpose fault."""
    for got in run['ranks']:
        for what in ('train', 'frozen', 'sampled'):
            spread = got[what]['spread']
            assert spread.numel() > 0 and torch.count_nonzero(spread) == 0, (what, spread)
    local = [got['train']['local'] for got in run['ranks']]
    full = run['ranks'][0]['train']['after']
    n_rep = n_shard = 0
    for k, v in full.items():
        if local[0][k].shape == v.shape:
            n_rep += 1
            assert all(torch.equal(loc[k], local[0][k]) for loc in local), k
        else:
            n_shard += 1
            for m in range(ranks.TP):
                assert torch.equal(local[m][k], local[ranks.TP + m][k]), k
            assert not torch.equal(local[0][k], local[1][k]), k
    assert n_rep > 0 and n_shard > 0


def test_frozen_bn_step_matches_the_unsharded_step(run):
    """The frozen-BN step (running averages, the standard blocks: a sharded
    block does not fuse) on the ranks against the port's unsharded frozen
    step (itself held to JAX in test_torch_port_train_step.py)."""
    ref = run['refs']['one_frozen']
    for got in run['ranks']:
        t = got['frozen']
        assert abs(float(t['loss']) - ref['loss']) <= TOL_F64 * max(abs(ref['loss']), 1.0)
        assert _worst(_np(t['grads']), ref['grads'])[0] <= TOL_F64
        assert _worst(_np(t['after']), ref['after'], 1.0)[0] <= TOL_UPDATE


def test_sampled_statistics_under_dp_by_tp_match_jax(run):
    """TRAIN.bn_stat_samples = 6 on dp 2 x tp 2: the statistics are the
    global batch's first 6 rows (data rank 0's 4, data rank 1's first 2),
    summed over the DATA group only and indexed by the data coordinate (the
    `norm.py` repair: over the process group the four ranks would count
    each row twice and index the rows by process rank). The loss, the
    update and the running statistics against JAX's (2, 2) step with
    bn_stat_samples=6 and against the port's unsharded step."""
    for ref in (run['refs']['jax_sampled'], run['refs']['one_sampled']):
        for got in run['ranks']:
            t = got['sampled']
            assert abs(float(t['loss']) - ref['loss']) <= TOL_F64 * max(abs(ref['loss']), 1.0)
            assert _worst(_np(t['after']), ref['after'], 1.0)[0] <= TOL_SAMPLED_UPDATE


def test_mspn_tp_step_matches_the_unsharded_mspn(run):
    """The same rule and layers on MSPN (1 stage, no per-model code): one
    step's loss and gathered gradients against the port's unsharded MSPN
    from the same seed."""
    ref = run['refs']['mspn']
    for got in run['ranks']:
        t = got['mspn']
        assert t['sharded'] > 0
        assert abs(float(t['loss']) - ref['loss']) <= TOL_MSPN_LOSS * max(abs(ref['loss']), 1.0)
        assert _worst(_np(t['grads']), ref['grads'])[0] <= TOL_F64


def test_tp_trainer_trains_and_checkpoints_the_standard_layout(run):
    """The trainer CLI under TRAIN.model_parallel=2 on dp 2 x tp 2
    (tests/test_trainer_mesh.py:26): two epochs, BN frozen in the second,
    finite and the same on every rank; rank 0 alone writes, and
    checkpoint_1 holds the standard layout: every parameter, statistic and
    RMSprop accumulator at its full shape."""
    vals = [got['trainer']['val'] for got in run['ranks']]
    # straight: epochs 1 and 2; resumed and from one process: epoch 2
    assert vals[0].shape == (4, 3) and torch.isfinite(vals[0]).all()
    assert all(torch.equal(v, vals[0]) for v in vals)
    writes = [got['trainer']['writes'] for got in run['ranks']]
    assert all(w == [] for w in writes[1:])
    assert 'checkpoint_1' in writes[0] and writes[0].count('checkpoint_2') == 3
    ckpt = torch.load(run['work'] / 'straight' / ranks.RUN_NAME / 'ckpts' / 'checkpoint_1',
                      weights_only=True)
    standard = HourglassNet(**ranks.MODEL_KW)
    assert {k: v.shape for k, v in ckpt['model'].items()} == {
        k: v.shape for k, v in standard.state_dict().items()}
    shapes = [p.shape for p in standard.parameters()]
    assert len(ckpt['optimizer']['state']) == len(shapes)
    assert all(st['square_avg'].shape == shapes[i] for i, st in ckpt['optimizer']['state'].items())


def test_tp_resume_restores_and_shards_the_same_leaves(run, tmp_path):
    """tests/test_trainer_mesh.py:45: a resume under tensor parallelism
    (from the TP run's checkpoint_1, and from one process's checkpoint
    without it) holds exactly the file's tensors, gathered, and shards the
    same leaves as a fresh start; one process without tensor parallelism
    resumes the TP checkpoint exactly (parameters and statistics)."""
    for got in run['ranks']:
        tr = got['trainer']
        assert tr['restored_exactly'] == [True, True]
        assert len(set(tr['sharded_leaves'])) == 1 and tr['sharded_leaves'][0] > 0
    ckpt = run['work'] / 'straight' / ranks.RUN_NAME / 'ckpts' / 'checkpoint_1'
    saved = torch.load(ckpt, weights_only=True)
    one = Trainer(_trainer_cfg(tmp_path, 'one', 'TRAIN.model_parallel=1', f'COMMON.resume={ckpt}'),
                  verbose=False, device='cpu')
    assert one.start_epoch == 1 and one.state.step == saved['step']
    assert all(torch.equal(v, saved['model'][k]) for k, v in one.model.state_dict().items())


def test_evaluate_only_reads_the_tp_checkpoint(run, tmp_path, capsys):
    """`evaluate_only` in one process on the TP run's checkpoint_1 reads the
    (loss, PCK) of the TP trainer's validation of those weights (the
    gathered replica, its rows over the 4 ranks)."""
    ckpt = run['work'] / 'straight' / ranks.RUN_NAME / 'ckpts' / 'checkpoint_1'
    assert train_and_evaluate.main([TINY] + ranks.TRAINER_ARGS + [
        'TRAIN.model_parallel=1', 'COMMON.evaluate_only=true', f'COMMON.resume={ckpt}',
        f'COMMON.checkpoint_dir={tmp_path}', '--device', 'cpu']) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('loss ')][-1]
    loss, acc = float(line.split()[1]), float(line.split()[4])
    val_loss, val_acc, _ = run['ranks'][0]['trainer']['val'][0].tolist()
    assert loss == pytest.approx(val_loss, rel=TOL_EVALUATOR, abs=1e-5)
    assert acc == pytest.approx(val_acc, abs=1e-4)


def test_explicit_path_refuses_tensor_parallelism():
    """tests/test_trainer_mesh.py:90: the config refuses the explicit step
    with model_parallel > 1, as JAX's does."""
    with pytest.raises(ValueError, match='model_parallel=1'):
        tconfig.load_config(TINY, overrides=['TRAIN.explicit_collectives=true',
                                             'TRAIN.model_parallel=2'])


def _overlap_setup():
    """The overlapped steps' data, the JAX state (a narrow 1-stack model in
    f32) and a function that makes the port's state with its weights."""
    ds = Synthetic(True, **OVERLAP_DS)
    jspec = jax_make_spec(JaxSynthetic(True, **OVERLAP_DS))
    jstate = jts.init_state(JaxNet(dtype=jnp.float32, **OVERLAP_MODEL), jax.random.PRNGKey(0),
                            (1, 64, 64, 3), jts.make_optimizer(*OVERLAP_LR))
    variables = jax.tree.map(np.asarray, {'params': jstate.params,
                                          'batch_stats': jstate.batch_stats})

    def port_state():
        model = load_jax_variables(HourglassNet(dtype=torch.float32, **OVERLAP_MODEL), variables)
        return tts.init_state(model.to(memory_format=torch.channels_last),
                              tts.make_optimizer(*OVERLAP_LR))
    raws = [ds.canvas_batch(list(range(i * 8, i * 8 + 8)), canvas=64) for i in range(4)]
    return make_spec(ds), jspec, jstate, port_state, raws


def _jax_overlapped(jspec, jstate, raws) -> list:
    """JAX's overlapped run (tests/test_train.py:161): prime with batch 0,
    then three overlapped steps staging batches 1-3 -> their losses (the
    drain is the sequential step on staged data, held to JAX's in
    test_torch_port_train_step.py)."""
    from hourglass_pose_estimation_tpu.runner.train_state import (
        make_overlapped_train_step, make_stage_fn)
    rng = jax.random.PRNGKey(OVERLAP_KEY)
    step = make_overlapped_train_step(jspec)
    staged, losses, s = make_stage_fn(jspec)(raws[0], rng, jstate.step), [], jstate
    for raw in raws[1:]:
        s, staged, m = step(s, staged, raw, rng)
        losses.append(float(m['loss']))
    return losses


def test_overlapped_step_matches_sequential_and_jax(run, monkeypatch):
    """tests/test_train.py:161 for the port: prime with batch 0, three
    overlapped steps staging batches 1-3, a drain. Each staged image batch
    is bit-equal to the sequential step's augmentation of that batch (the
    same step generator), every loss, the drain's included, equals the
    sequential step's exactly (the same step on the same tensors), and they
    track JAX `make_overlapped_train_step`'s three (JAX's fold_in(rng, s)
    draws injected into the port by step): the first within 4e-6 relative,
    the trajectory within the JAX test's 0.05."""
    spec, _, _, port_state, raws = _overlap_setup()
    kw = dict(scale_factor=spec.scale_factor, rot_factor=spec.rot_factor)
    key = jax.random.PRNGKey(OVERLAP_KEY)
    draws = {s: tuple(torch.from_numpy(np.array(d)) for d in jax_sample(
        jax.random.fold_in(key, s), jnp.asarray(raws[s]['scale']), train=True, **kw))
        for s in range(4)}
    plain = tts.sample_augmentations
    # the port draws step s's augmentations from step s's generator
    monkeypatch.setattr(tts, 'step_generator', lambda seed, step, device, rank=None: step)
    monkeypatch.setattr(tts, 'sample_augmentations', lambda gen, scales, **k: (
        draws[gen] if k['train'] else plain(gen, scales, **k)))
    seq, state, seq_losses, seq_imgs = tts.make_train_step(spec), port_state(), [], []
    for i, raw in enumerate(raws):
        seq_imgs.append(augment_batch(to_device(raw, 'cpu'), draws[i], spec, True)['image'])
        state, m = seq(state, raw, OVERLAP_KEY)
        seq_losses.append(float(m['loss']))
    stage = tts.make_stage_fn(spec, device='cpu')
    state, ostep = port_state(), tts.make_overlapped_train_step(spec)
    drain = tts.make_train_step(spec, device_pipeline=False)
    staged, losses = stage(raws[0], OVERLAP_KEY, state.step), []
    for i, raw in enumerate(raws[1:]):
        assert torch.equal(staged['image'], seq_imgs[i])
        state, staged, m = ostep(state, staged, raw, OVERLAP_KEY)
        losses.append(float(m['loss']))
    assert torch.equal(staged['image'], seq_imgs[3])
    state, m = drain(state, staged, OVERLAP_KEY)
    losses.append(float(m['loss']))
    assert state.step == 4
    jlosses = run['refs']['overlapped']
    assert losses == seq_losses
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=TOL_OVERLAP_FIRST)
    np.testing.assert_allclose(losses[:3], jlosses, rtol=TOL_OVERLAP_TRAJECTORY)
