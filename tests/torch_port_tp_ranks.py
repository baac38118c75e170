"""One rank of the port's tensor-parallel CPU tests (gloo), started by
tests/test_torch_port_tensor_parallel.py as its own process:

    RANK=r WORLD_SIZE=4 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_tp_ranks.py <work dir>

With `--card <backend>` before the work dir it is one of two ranks (data 1
x model 2) that tests/test_torch_port_cuda.py starts: `gloo` both on
cuda:0 (every collective through host memory), `nccl` on cuda:0 and cuda:1;
one tensor-parallel train step of a 1-stack bf16 model with the kernels,
whose launches it writes to `<work dir>/card<r>.json`.

It imports torch and the port only, reads `<work dir>/inputs.pt` (JAX's
weights and a batch, as numpy-made tensors) and writes `<work
dir>/rank<r>.pt`: on a (data 2 x model 2) layout, each autograd transpose
and sharded layer alone, the fused blocks that sharding closes, the
tensor-parallel train step in f64 (train mode: loss, gathered gradients
and the update, then two more steps; the frozen-BN step; the step with sampled statistics; each with how far the
model ranks' replicated gradients were apart), one MSPN step, and the
trainer CLI under TRAIN.model_parallel=2 (two epochs, the second with BN
frozen; a resume from its checkpoint_1; a resume from a checkpoint of one
process without tensor parallelism)."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import torch
import torch.distributed

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hourglass_pose_estimation_torch import train_and_evaluate  # noqa: E402
from hourglass_pose_estimation_torch.data import Synthetic, make_spec  # noqa: E402
from hourglass_pose_estimation_torch.models import HourglassNet, mspn  # noqa: E402
from hourglass_pose_estimation_torch.models.modules import Bottleneck, Conv  # noqa: E402
from hourglass_pose_estimation_torch.models.norm import BatchNorm  # noqa: E402
from hourglass_pose_estimation_torch.ops.hopper import launch_counts  # noqa: E402
from hourglass_pose_estimation_torch.parallel import (  # noqa: E402
    ShardedTrainState, gather_params, make_mesh, maybe_initialize_distributed, shard_model,
    sync_batch_norm)
from hourglass_pose_estimation_torch.parallel import tensor_parallel as tpl  # noqa: E402
from hourglass_pose_estimation_torch.runner import checkpoint, train_state  # noqa: E402
from hourglass_pose_estimation_torch.utils import tracing  # noqa: E402
from hourglass_pose_estimation_torch.weights import load_jax_variables  # noqa: E402

WORLD, DP, TP = 4, 2, 2
# tests/test_trainer_mesh.py's sizes: 1 stack, 128 features (so that the
# rule shards: every conv of 128 or 256 outputs), 64^2 -> 16^2, a global
# batch of 8 (4 a data rank)
B, RES, J = 8, 64, 16
MODEL_KW = dict(num_stacks=1, num_blocks=1, num_classes=J, num_feats=128)
LR = (2.5e-3, [], 0.1, 4)
# sampled statistics: the global batch's first 6 rows (data rank 0's 4 and
# data rank 1's first 2), torch_port_ranks.STEP_STAT_SAMPLES
STAT_SAMPLES = 6
# steps after which the replicated parameters are compared across ranks
STEPS = 3
# the trainer CLI: configs/train_synthetic_tiny.yaml (1 stack, 128
# features, 64^2, f32) on 16 samples, dp 2 x tp 2: one step of 8 an epoch
# (4 rows a data rank), two epochs, BN frozen in the second, and 2
# validation batches of 8 (2 rows a rank)
TRAINER_ARGS = ['TRAIN.model_parallel=2', 'DATASET.num_samples=16', 'TRAIN.train_batch=8',
                'TRAIN.val_batch=8', 'TRAIN.steps_per_epoch=1', 'TRAIN.learning_rate=2.5e-5',
                'COMMON.snapshot=1']
RUN_NAME = 'synthetic_hg_s1_non-mobile_all'
TIMEOUT_S = 300
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hourglass_pose_estimation_tpu')


def rows(d: int) -> slice:
    b = B // DP
    return slice(d * b, (d + 1) * b)


def unit_inputs(seed: int = 3):
    """The inputs of the layer checks, the same in every process (a seeded
    generator): x [2, 8, 5, 5], the output gradient, and the weights of a
    plain, a grouped (2 groups) and a depthwise conv of 8 outputs."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    return dict(x=r(2, 8, 5, 5), gy=r(2, 8, 5, 5),
                convs={1: (r(8, 8, 3, 3), r(8)), 2: (r(8, 4, 1, 1), r(8)),
                       8: (r(8, 1, 3, 3), r(8))},
                bn=(r(8), r(8), r(8), r(8).abs() + 0.5))


def plain_conv(groups: int, w, b) -> Conv:
    conv = Conv(8, 8, w.shape[-1], groups=groups, dtype=torch.float64).double()
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    return conv


def plain_bn(params) -> BatchNorm:
    bn = BatchNorm(8).double()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), params):
            t.copy_(v)
    return bn


def units(mesh) -> dict:
    """Each transpose and sharded layer alone on the model group (a mesh
    whose rule shards 8 channels: min_shard_dim is the rule's, so these
    layers are built by hand)."""
    m, out = mesh.model_rank, {}
    # the output gather: forward the concatenation, backward this rank's slice
    x = torch.arange(2 * 3 * 4, dtype=torch.float64).view(2, 3, 4).add(100 * m)
    x.requires_grad_(True)
    y = tpl.GatherChannels.apply(x, mesh.model_group, 1, m)
    gy = torch.arange(y.numel(), dtype=torch.float64).view(y.shape)
    y.backward(gy)
    out['gather'] = (y.detach(), x.grad)
    # the input's identity: the backward sums over the model group
    x = torch.ones(3, dtype=torch.float64, requires_grad=True)
    (tpl.SumGradOverModel.apply(x, mesh.model_group) * (m + 2)).sum().backward()
    out['sum_grad'] = x.grad
    inp = unit_inputs()
    for groups, (w, b) in inp['convs'].items():
        conv = tpl.ShardedConv(plain_conv(groups, w, b), mesh)
        x = inp['x'].clone().requires_grad_(True)
        y = conv(x)
        y.backward(inp['gy'])
        out[f'conv{groups}'] = (y.detach(), x.grad, conv.weight.grad, conv.bias.grad)
    bn = tpl.ShardedBatchNorm(plain_bn(inp['bn']), mesh)
    x = inp['x'].clone().requires_grad_(True)
    y = bn(x, train=True)
    y.backward(inp['gy'])
    out['bn_train'] = (y.detach(), x.grad, bn.weight.grad, bn.bias.grad,
                       bn.running_mean.clone(), bn.running_var.clone())
    out['bn_eval'] = bn(inp['x'], train=False).detach()
    return out


def hg_f64(stat_samples: int = 0) -> HourglassNet:
    """The 1-stack model in f64 (parameters, statistics and compute)."""
    model = HourglassNet(dtype=torch.float64, out_dtype=torch.float64,
                         bn_stat_samples=stat_samples, **MODEL_KW).double()
    return model.to(memory_format=torch.channels_last)


def sharded_state(variables, mesh, stat_samples: int = 0):
    """The model with JAX's weights and the DATA group's statistics (the
    global batch's first rows, as the Trainer's implicit path), sharded as
    the Trainer shards it -> (the ShardedTrainState, the standard layout's
    shapes, whether `load_jax_variables` with the mesh fills a sharded
    model with the same tensors)."""
    model = load_jax_variables(hg_f64(stat_samples), variables)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    sync_batch_norm(model, global_rows=True, group=mesh.group)
    state = ShardedTrainState.create(model, train_state.make_optimizer(*LR), mesh)
    direct = load_jax_variables(shard_model(hg_f64(stat_samples), mesh), variables, mesh)
    same = all(torch.equal(v, direct.state_dict()[k]) for k, v in model.state_dict().items())
    return state, shapes, same


def fusable_blocks(mesh) -> tuple:
    """The bottlenecks whose fused path is open in the 1-stack model with
    `fuse_block` on: before sharding, in the sharded model, and in its
    standard replica (`ShardedTrainState.standard`)."""
    count = lambda model: sum(1 for m in model.modules()
                              if isinstance(m, Bottleneck) and m.fusable())
    model = HourglassNet(fuse_block=True, **MODEL_KW)
    before = count(model)
    state = ShardedTrainState.create(model, train_state.make_optimizer(*LR), mesh)
    return before, count(state.model), count(state.standard)


def step_run(inp, mesh, freeze_bn: bool = False, stat_samples: int = 0, steps: int = 1) -> dict:
    """`steps` train steps (host pipeline: the batch is JAX-staged) on this
    data rank's rows: the first step's loss, PCK and gathered gradients,
    the gathered state after it, and this rank's own state and its
    replicated gradients' spread (`ShardedTrainState.replicated_spread`)
    after the last."""
    state, shapes, loader_same = sharded_state(inp['variables'], mesh, stat_samples)
    model = state.model
    step = train_state.make_train_step(None, device_pipeline=False, freeze_bn=freeze_bn,
                                       mesh=mesh)
    batch = {k: inp[k][rows(mesh.rank)] for k in ('image', 'target', 'target_weight')}
    state, m = step(state, batch, 0)
    copy = lambda d: {k: v.clone() for k, v in d.items()}     # later steps write in place
    out = {'loss': m['loss'], 'acc': m['acc'], 'jax_loader_same': loader_same,
           'grads': copy(gather_params({n: p.grad for n, p in model.named_parameters()}, mesh,
                                       shapes)),
           'after': copy(gather_params(model.state_dict(), mesh, shapes))}
    for _ in range(steps - 1):
        state, m = step(state, batch, 0)
    out['local'] = {k: v.clone() for k, v in model.state_dict().items()}
    out['spread'] = state.replicated_spread.clone()
    return out


def mspn_run(mesh) -> dict:
    """One MSPN train step (1 stage, f64, seeded weights) on this data
    rank's rows of a seeded batch: the loss and the gathered gradients."""
    torch.manual_seed(0)
    model = mspn(device='cpu', num_stacks=1, num_classes=J, out_res=RES // 4,
                 dtype=torch.float64).double()
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    sync_batch_norm(shard_model(model, mesh), global_rows=True, group=mesh.group)
    state = train_state.init_state(model, train_state.make_optimizer(*LR))
    step = train_state.make_train_step(None, device_pipeline=False, mesh=mesh)
    state, m = step(state, {k: v[rows(mesh.rank)] for k, v in mspn_batch().items()}, 0)
    return {'loss': m['loss'],
            'grads': gather_params({n: p.grad for n, p in model.named_parameters()}, mesh,
                                   shapes),
            'sharded': sum(1 for mod in model.modules() if getattr(mod, 'sharded', False))}


def mspn_batch() -> dict:
    g = torch.Generator().manual_seed(5)
    return dict(image=torch.randn(B, RES, RES, 3, generator=g, dtype=torch.float64),
                target=torch.rand(B, RES // 4, RES // 4, J, generator=g, dtype=torch.float64),
                target_weight=torch.ones(B, J, dtype=torch.float64))


def same_as_file(state, path) -> bool:
    """Whether a sharded train state, gathered (a collective), holds
    exactly the checkpoint file's tensors."""
    saved = torch.load(path, weights_only=True)
    model, opt = state.checkpoint_state()

    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(v, b[k]) for k, v in a.items())
        if isinstance(a, list):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    return (equal(model, saved['model']) and equal(opt['state'], saved['optimizer']['state'])
            and len(opt['state']) > 0 and state.step == saved['step'])


def sharded_leaves(state) -> int:
    """The parameters and statistics that hold a shard."""
    full = {k: v.shape for k, v in state.standard.state_dict().items()}
    return sum(1 for k, v in state.model.state_dict().items() if v.shape != full[k])


def trainer_runs(work: Path) -> dict:
    """The trainer CLI under TRAIN.model_parallel=2: two epochs (BN frozen
    in the second), a resume from its checkpoint_1 to epoch 2 in another
    directory, and a resume from `<work>/one/ckpts/checkpoint_1` (one process,
    no tensor parallelism). Records this rank's checkpoint writes, each
    run's history, the sharded leaves, and whether each resumed state is
    its file's, exactly."""
    writes, histories, restored, leaves = [], [], [], []

    def counted(path, payload):
        writes.append(os.path.basename(path))
        return write(path, payload)

    class Recording(train_and_evaluate.Trainer):
        def __init__(self, cfg, **kwargs):
            super().__init__(cfg, **kwargs)
            leaves.append(sharded_leaves(self.state))
            if cfg.common.resume:
                restored.append(same_as_file(self.state, cfg.common.resume))

        def train(self):
            try:
                return super().train()
            finally:
                histories.append(self.history)

    write, checkpoint._write = checkpoint._write, counted
    trainer, train_and_evaluate.Trainer = train_and_evaluate.Trainer, Recording
    base = [str(REPO / 'configs' / 'train_synthetic_tiny.yaml')] + TRAINER_ARGS + [
        'TRAIN.epochs=2']
    try:
        for name, extra in (
                ('straight', ['TRAIN.freeze_bn_after_epoch=1']),
                ('resumed', [f'COMMON.resume={work}/straight/{RUN_NAME}/ckpts/checkpoint_1']),
                ('from_one', [f'COMMON.resume={work}/one/ckpts/checkpoint_1'])):
            train_and_evaluate.main(base + extra + [f'COMMON.checkpoint_dir={work}/{name}',
                                                   '--device', 'cpu', '--backend', 'gloo'])
    finally:
        checkpoint._write, train_and_evaluate.Trainer = write, trainer
    return {'writes': writes, 'restored_exactly': restored, 'sharded_leaves': leaves,
            'val': torch.tensor([[h['val_loss'], h['val_acc'], h['train_loss']]
                                 for run in histories for h in run], dtype=torch.float64)}


def main(work: Path) -> int:
    torch.set_num_threads(1)
    rank, world = maybe_initialize_distributed(device='cpu', timeout=TIMEOUT_S, verbose=False)
    assert world == WORLD, world
    inp = torch.load(work / 'inputs.pt', weights_only=True)
    mesh = make_mesh(DP, TP, 'cpu')
    out = {'mesh': (mesh.world, mesh.rank, mesh.model, mesh.model_rank, mesh.process_rank,
                    mesh.size),
           'units': units(mesh),
           'fusable': fusable_blocks(mesh),
           'train': step_run(inp, mesh, steps=STEPS),
           'frozen': step_run(inp, mesh, freeze_bn=True),
           'sampled': step_run(inp, mesh, stat_samples=STAT_SAMPLES),
           'mspn': mspn_run(mesh),
           'trainer': trainer_runs(work)}
    out['forbidden_modules'] = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
    torch.save(out, work / f'rank{rank}.pt')
    torch.distributed.destroy_process_group()
    return 0


# the card's ranks: data 1 x model 2, a 1-stack bf16 model with the kernels
# at 64^2, a batch of 4
CARD_KW = dict(num_stacks=1, num_blocks=1, num_classes=16, dtype=torch.bfloat16,
               fuse_upsample=True, fuse_block=True)
CARD_BATCH, CARD_RES = 4, 64


def card_main(backend: str, work: Path) -> int:
    device = 'cuda:0' if backend == 'gloo' else 'cuda'      # nccl: cuda:LOCAL_RANK
    rank, world = maybe_initialize_distributed(device, backend=backend, timeout=TIMEOUT_S,
                                               verbose=False)
    assert world == 2, world
    mesh = make_mesh(1, 2, device)
    torch.manual_seed(0)
    model = HourglassNet(**CARD_KW).to(mesh.device, memory_format=torch.channels_last)
    state = ShardedTrainState.create(model, train_state.make_optimizer(*LR), mesh)
    ds = Synthetic(True, num_samples=CARD_BATCH, inp_res=CARD_RES, out_res=CARD_RES // 4,
                   sigma=1, scale_factor=0.25, rot_factor=30)
    step = train_state.make_train_step(make_spec(ds), mesh=mesh)
    raw = ds.canvas_batch(range(CARD_BATCH), canvas=CARD_RES)
    tracing.reset()
    state, m = step(state, raw, 0)
    out = dict(model_rank=mesh.model_rank, device=str(mesh.device), loss=float(m['loss']),
               collectives=tracing.counters()['tp.collective_calls'],
               sharded_leaves=sharded_leaves(state), launches=launch_counts())
    (work / f'card{rank}.json').write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == '__main__':
    if sys.argv[1] == '--card':
        sys.exit(card_main(sys.argv[2], Path(sys.argv[3])))
    sys.exit(main(Path(sys.argv[1])))
