"""One rank of the port's data-parallel CPU tests (gloo), started by
tests/test_torch_port_parallel.py as its own process:

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_ranks.py <work dir>

It imports torch and the port only (a child that imported the test module
would load JAX and the conftest's device flags), reads `<work
dir>/inputs.pt` and writes `<work dir>/rank<r>.pt`: the sync-BN forward and
backward, the implicit (DDP) step with and without remat, with full and
with sampled statistics (the global batch's first STEP_STAT_SAMPLES rows),
the explicit step with sync_bn on and off, two runs of the trainer CLI
(two epochs, and a resume from the first run's checkpoint_1) and the
standalone evaluator CLI on that checkpoint_1."""

from __future__ import annotations

import contextlib
import io
import os
import sys
from pathlib import Path

import torch
import torch.distributed

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hourglass_pose_estimation_torch import train_and_evaluate  # noqa: E402
from hourglass_pose_estimation_torch.data import Synthetic, make_spec  # noqa: E402
from hourglass_pose_estimation_torch.models import HourglassNet  # noqa: E402
from hourglass_pose_estimation_torch.models.norm import BatchNorm  # noqa: E402
from hourglass_pose_estimation_torch.parallel import (  # noqa: E402
    make_mesh, make_shard_map_train_step, maybe_initialize_distributed, shard_map_step,
    sync_batch_norm)
from hourglass_pose_estimation_torch.runner import checkpoint  # noqa: E402
from hourglass_pose_estimation_torch.runner import train_state  # noqa: E402

WORLD = 2
BATCH = 8                        # global; 4 rows a rank
DS_KW = dict(num_samples=8, inp_res=64, out_res=16, sigma=1, scale_factor=0.25,
             rot_factor=30)
MODEL_KW = dict(num_stacks=1, num_blocks=1, num_classes=16, num_feats=16)
LR = (2.5e-3, [], 0.1, 4)
SEED = 7
STEPS = 2
STAT_SAMPLES = 2
# the lone BatchNorm's sampled statistics: (path, k), the implicit path's k
# within rank 0's rows and across both ranks'
STAT_SAMPLE_CASES = (('explicit', 2), ('implicit', 2), ('implicit', 6))
# the implicit step's sampled statistics: the global batch's first 6 rows,
# rank 0's 4 and rank 1's first 2 (each rank's first 6 would be all 8). With
# k <= 4 rows the statistics at the hourglass's 1x1 bottom level are so
# narrow that the step-1 loss reads 214 (k=4) to 7e8 (k=2), and the
# rounding noise of the gradients of the conv biases that feed a BatchNorm
# (0 in exact arithmetic) reaches RMSprop's eps: their updates then differ
# by 1e-3 between any two summation orders, one process's against JAX's too
STEP_STAT_SAMPLES = 6
# every collective and the rendezvous give up after this many seconds
TIMEOUT_S = 120
# the trainer CLI's run: configs/train_synthetic_tiny.yaml (1 stack, 64^2,
# f32) on 10 samples: one step of 8 an epoch, and 3 validation batches of
# 4, the last with 2 padded rows (all of rank 1's)
TRAINER_ARGS = ['DATASET.num_samples=10', 'TRAIN.train_batch=8', 'TRAIN.val_batch=4',
                'TRAIN.learning_rate=2.5e-5',
                'COMMON.snapshot=1']
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hourglass_pose_estimation_tpu')


def model_f64(state_dict, remat: bool = False, stat_samples: int = 0) -> HourglassNet:
    """The tests' model in f64 throughout (parameters, statistics and
    compute: with f32 parameters the ranks' f32 gradients cancel in their
    average where one process's f64 sum does not) with the given weights."""
    model = HourglassNet(dtype=torch.float64, out_dtype=torch.float64, remat=remat,
                         bn_stat_samples=stat_samples,
                         **MODEL_KW).double().to(memory_format=torch.channels_last)
    model.load_state_dict(state_dict)
    return model


def rows(rank: int) -> slice:
    b = BATCH // WORLD
    return slice(rank * b, (rank + 1) * b)


def sync_bn_run(inp, rank: int) -> dict:
    """Train-mode forward and backward of sum(outs * ct) on this rank's rows
    with synced statistics; a lone BatchNorm with stat_samples on each
    path's rows (STAT_SAMPLE_CASES)."""
    model = sync_batch_norm(model_f64(inp['state_dict']))
    x = inp['x'][rows(rank)].clone().requires_grad_(True)
    outs = model(x, train=True)
    (outs * inp['ct'][:, rows(rank)]).sum().backward()
    sampled = {}
    for path, k in STAT_SAMPLE_CASES:
        bn = sync_batch_norm(BatchNorm(3, stat_samples=k).double(),
                             global_rows=path == 'implicit')
        bn(inp['x'][rows(rank)].permute(0, 3, 1, 2), train=True)
        sampled[f'{path}{k}'] = torch.stack([bn.running_mean, bn.running_var])
    return {'outs': outs.detach(), 'dx': x.grad,
            'grads': {n: p.grad for n, p in model.named_parameters()},
            'state': model.state_dict(), 'stat_samples': sampled}


def steps_run(inp, rank: int, step, module, draws, model) -> dict:
    """STEPS train steps of `step` on this rank's rows, with `draws` (one a
    step) handed to `module`'s `sample_augmentations`."""
    state = train_state.init_state(model, train_state.make_optimizer(*LR))
    raw = {k: v[rows(rank)] for k, v in inp['raw'].items()}
    it = iter(draws)
    saved = module.sample_augmentations
    module.sample_augmentations = lambda gen, scales, **kw: next(it)
    try:
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, raw, SEED)
            metrics.append([float(m['loss']), float(m['acc'])])
    finally:
        module.sample_augmentations = saved
    return {'metrics': torch.tensor(metrics, dtype=torch.float64),
            'state': model.state_dict()}


def same_as_file(state, path) -> bool:
    """Whether a train state holds exactly the checkpoint file's tensors."""
    saved = torch.load(path, weights_only=True)
    model, opt = state.model.state_dict(), state.optimizer.state_dict()['state']
    return (model.keys() == saved['model'].keys()
            and all(torch.equal(v, saved['model'][k]) for k, v in model.items())
            and len(opt) == len(saved['optimizer']['state']) > 0
            and all(torch.equal(v, saved['optimizer']['state'][i][k])
                    for i, st in opt.items() for k, v in st.items())
            and state.step == saved['step'])


def trainer_runs(work: Path, rank: int) -> dict:
    """The trainer CLI on the ranks: two epochs, then a resume from that
    run's checkpoint_1 to epoch 2 in another directory. Records this rank's
    checkpoint writes, each run's validation, and whether the resumed state
    is the file's, exactly."""
    writes, histories, restored = [], [], []

    def counted(path, payload):
        writes.append(os.path.basename(path))
        return write(path, payload)

    class Recording(train_and_evaluate.Trainer):
        def __init__(self, cfg, **kwargs):
            super().__init__(cfg, **kwargs)
            if cfg.common.resume:
                restored.append(same_as_file(self.state, cfg.common.resume))

        def train(self):
            try:
                return super().train()
            finally:
                histories.append(self.history)

    write, checkpoint._write = checkpoint._write, counted
    trainer, train_and_evaluate.Trainer = train_and_evaluate.Trainer, Recording
    base = [str(REPO / 'configs' / 'train_synthetic_tiny.yaml')] + TRAINER_ARGS + ['TRAIN.epochs=2']
    try:
        for name, extra in (('straight', []), ('resumed', [
                f'COMMON.resume={work}/straight/synthetic_hg_s1_non-mobile_all/ckpts/checkpoint_1'])):
            train_and_evaluate.main(base + extra + [f'COMMON.checkpoint_dir={work}/{name}',
                                                   '--device', 'cpu', '--backend', 'gloo'])
    finally:
        checkpoint._write, train_and_evaluate.Trainer = write, trainer
    return {'writes': writes, 'restored_exactly': restored,
            'val': torch.tensor([[h['val_loss'], h['val_acc']] for run in histories for h in run],
                                dtype=torch.float64)}


def evaluate_only_run(work: Path) -> dict:
    """The evaluator CLI (COMMON.evaluate_only) under the process group on
    the trainer's checkpoint_1: every rank's (loss, PCK) and what it
    printed."""
    got = []

    class Recording(train_and_evaluate.Evaluator):
        def evaluate(self, state):
            got.append(super().evaluate(state))
            return got[-1]

    evaluator, train_and_evaluate.Evaluator = train_and_evaluate.Evaluator, Recording
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            train_and_evaluate.main(
                [str(REPO / 'configs' / 'train_synthetic_tiny.yaml')] + TRAINER_ARGS + [
                    'COMMON.evaluate_only=true', f'COMMON.checkpoint_dir={work}/evaluated',
                    f'COMMON.resume={work}/straight/synthetic_hg_s1_non-mobile_all/ckpts/'
                    'checkpoint_1', '--device', 'cpu', '--backend', 'gloo'])
    finally:
        train_and_evaluate.Evaluator = evaluator
    return {'metrics': torch.tensor(got, dtype=torch.float64), 'printed': out.getvalue()}


def main(work: Path) -> int:
    torch.set_num_threads(1)
    rank, world = maybe_initialize_distributed(device='cpu', timeout=TIMEOUT_S, verbose=False)
    assert world == WORLD, world
    inp = torch.load(work / 'inputs.pt', weights_only=True)
    spec = make_spec(Synthetic(True, **DS_KW))
    mesh = make_mesh(0, 1, 'cpu')
    out = {'sync_bn': sync_bn_run(inp, rank)}
    for remat in (False, True):
        for k in (0, STEP_STAT_SAMPLES):
            # as the Trainer builds the implicit path's model
            model = sync_batch_norm(model_f64(inp['state_dict'], remat, k), global_rows=True)
            out[f'implicit_remat{int(remat)}' + (f'_k{k}' if k else '')] = steps_run(
                inp, rank, train_state.make_train_step(spec, mesh=mesh), train_state,
                inp['draws_global'], model)
    for sync in (True, False):
        model = model_f64(inp['state_dict'])
        out[f'explicit_sync{int(sync)}'] = steps_run(
            inp, rank, make_shard_map_train_step(spec, mesh, sync_bn=sync), shard_map_step,
            inp['draws_rank'][rank], sync_batch_norm(model) if sync else model)
    out['trainer'] = trainer_runs(work, rank)
    out['evaluate_only'] = evaluate_only_run(work)
    out['forbidden_modules'] = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
    torch.save(out, work / f'rank{rank}.pt')
    torch.distributed.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main(Path(sys.argv[1])))
