"""One rank of the port's pipeline-parallel CPU tests (gloo), started by
tests/test_torch_port_pipeline.py as its own process:

    RANK=r WORLD_SIZE=4 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_pipeline_ranks.py <work dir>

With `--card gloo` before the work dir it is one of two ranks on one card
(cuda:0, gloo) that tests/test_torch_port_cuda.py starts: a hand-off of a
CUDA tensor staged through host memory, and one pipelined train step of a
2-stack bf16 model with the kernels, whose launches it writes to `<work
dir>/card<r>.json`. With `--card nccl` the two ranks are on two cards
(cuda:LOCAL_RANK, NCCL) and hand off device to device.

It imports torch and the port only, reads `<work dir>/inputs.pt` (JAX's
pipeline weights and batches, as numpy-made tensors) and writes `<work
dir>/rank<r>.pt`: on a (data 2 x pipe 2) layout, the pipelined step in
eval mode (loss and gradients), in train mode in f64 (loss and gradients)
and one update (parameters and statistics after), then the pipeline
trainer CLI (one epoch, and a pipeline resume from its checkpoint_1)."""

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
from hourglass_pose_estimation_torch.parallel import (  # noqa: E402
    make_mesh, maybe_initialize_distributed)
from hourglass_pose_estimation_torch.data import Synthetic, make_spec  # noqa: E402
from hourglass_pose_estimation_torch.ops.hopper import launch_counts  # noqa: E402
from hourglass_pose_estimation_torch.parallel import pipeline  # noqa: E402
from hourglass_pose_estimation_torch.parallel.pipeline import (  # noqa: E402
    PipelineState, build_stage, make_pipeline_train_step)
from hourglass_pose_estimation_torch.runner import checkpoint  # noqa: E402
from hourglass_pose_estimation_torch.runner.train_state import make_optimizer  # noqa: E402
from hourglass_pose_estimation_torch.utils import tracing  # noqa: E402
from hourglass_pose_estimation_torch.weights import load_jax_pipeline_variables  # noqa: E402

WORLD, DP, PP = 4, 2, 2
# tests/test_pipeline_parallel.py's sizes: 4 stacks (2 a stage), 4 joints,
# a global batch of 8 (4 a data rank, 2 microbatches of 2), 64^2, 64 features
S, J, B, RES, M, FEATS = 4, 4, 8, 64, 2, 64
LR = (2.5e-3, [35], 0.1, 100)
# the eval-mode step (depth-4 stacks) and the train-mode steps (depth-2
# stacks, two-pass variance), all in f64: (dtype, depth, fast variance). In
# f32 the two frameworks' convolutions round apart and flip the ReLU masks
# of near-zero activations: the eval-mode gradients then read 0.107
# relative on 3 of 8192 entries of one leaf (1.4e-3 of its largest value,
# past the JAX test's 1e-3 absolute gate)
MODES = {'eval': (torch.float64, 4, True), 'f64': (torch.float64, 2, False)}
# the pipeline trainer CLI: configs/train_synthetic_tiny.yaml (64^2, f32)
# with 2 stacks split 1 + 1, 2 microbatches, 16 samples: 2 steps of 8 an
# epoch, and 2 validation batches of 8 (2 rows a rank)
TRAINER_ARGS = ['MODEL.num_stacks=2', 'TRAIN.pipeline_parallel=2', 'TRAIN.microbatches=2',
                'DATASET.num_samples=16', 'TRAIN.train_batch=8', 'TRAIN.val_batch=8',
                'TRAIN.learning_rate=2.5e-5', 'COMMON.snapshot=1']
RUN_NAME = 'synthetic_hg_s2_non-mobile_all'
TIMEOUT_S = 300
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hourglass_pose_estimation_tpu')


def rows(d: int) -> slice:
    b = B // DP
    return slice(d * b, (d + 1) * b)


def stage(mesh, mode: str, variables) -> PipelineState:
    """This rank's stage in `mode`, with JAX's weights."""
    dtype, depth, fast = MODES[mode]
    stem, stacks = build_stage(S, mesh, 'cpu', num_feats=FEATS, num_blocks=1, num_classes=J,
                               depth=depth, dtype=dtype, out_dtype=dtype, bn_fast_variance=fast)
    for m in [stem] + stacks:
        m.to(dtype)
    k = len(stacks)
    load_jax_pipeline_variables(stem, stacks, variables['stem'], variables['stacked'],
                                range(mesh.stage * k, (mesh.stage + 1) * k))
    return PipelineState.create(stem, stacks, make_optimizer(*LR), mesh, S)


def step_run(inp, mesh, mode: str, train: bool, update: bool) -> dict:
    """One pipelined step on this data rank's rows."""
    data = inp[mode]
    state = stage(mesh, mode, data)
    step = make_pipeline_train_step(mesh, num_microbatches=M, train=train, update=update)
    r = rows(mesh.rank)
    state, m = step(state, data['images'][r], data['target'][r], data['tw'][r])
    out = {'loss': m['loss'], 'acc': m['acc']}
    if update:
        out['stem'] = state.stem.state_dict()
        out['stacks'] = [s.state_dict() for s in state.stacks]
    else:
        out['g_stem'], out['g_stack'] = m['g_stem'], m['g_stack']
    return out


def same_as_file(state, path) -> bool:
    """Whether a pipeline state holds exactly the checkpoint file's
    tensors (gathered and merged again: a collective)."""
    saved = torch.load(path, weights_only=True)
    model, opt = state.checkpoint_state()

    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(v, b[k]) for k, v in a.items())
        if isinstance(a, list):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    return (equal(model, saved['model']) and equal(opt, saved['optimizer'])
            and len(opt['stack']['state']) > 0 and state.step == saved['step'])


def trainer_runs(work: Path) -> dict:
    """The pipeline trainer CLI on the ranks: one epoch, then a pipeline
    resume from its checkpoint_1 to epoch 2 in another directory. Records
    this rank's checkpoint writes, each run's history, the first run's
    initial (merged) weights and whether the resumed state is the file's,
    exactly."""
    writes, histories, restored, start = [], [], [], []

    def counted(path, payload):
        writes.append(os.path.basename(path))
        return write(path, payload)

    class Recording(train_and_evaluate.Trainer):
        def __init__(self, cfg, **kwargs):
            super().__init__(cfg, **kwargs)
            if cfg.common.resume:
                restored.append(same_as_file(self.state, cfg.common.resume))
            else:
                start.append(self.state.hourglass_state())

        def train(self):
            try:
                return super().train()
            finally:
                histories.append(self.history)

    write, checkpoint._write = checkpoint._write, counted
    trainer, train_and_evaluate.Trainer = train_and_evaluate.Trainer, Recording
    base = [str(REPO / 'configs' / 'train_synthetic_tiny.yaml')] + TRAINER_ARGS
    try:
        for name, extra in (('straight', ['TRAIN.epochs=1']), ('resumed', [
                'TRAIN.epochs=2', f'COMMON.resume={work}/straight/{RUN_NAME}/ckpts/checkpoint_1'])):
            train_and_evaluate.main(base + extra + [f'COMMON.checkpoint_dir={work}/{name}',
                                                   '--device', 'cpu'])
    finally:
        checkpoint._write, train_and_evaluate.Trainer = write, trainer
    return {'writes': writes, 'restored_exactly': restored, 'start': start[0],
            'val': torch.tensor([[h['val_loss'], h['val_acc']] for run in histories for h in run],
                                dtype=torch.float64)}


def main(work: Path) -> int:
    torch.set_num_threads(1)
    rank, world = maybe_initialize_distributed(device='cpu', timeout=TIMEOUT_S, verbose=False)
    assert world == WORLD, world
    inp = torch.load(work / 'inputs.pt', weights_only=True)
    mesh = make_mesh(0, 1, 'cpu', pipeline_parallel=PP)
    assert (mesh.rank, mesh.stage) == divmod(rank, PP)
    out = {'mesh': (mesh.world, mesh.rank, mesh.pipe, mesh.stage),
           'eval': step_run(inp, mesh, 'eval', train=False, update=False),
           'train': step_run(inp, mesh, 'f64', train=True, update=False),
           'update': step_run(inp, mesh, 'f64', train=True, update=True),
           'trainer': trainer_runs(work)}
    out['forbidden_modules'] = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
    torch.save(out, work / f'rank{rank}.pt')
    torch.distributed.destroy_process_group()
    return 0


# the card's ranks: 2 stacks split 1 + 1, 128 features (the kernels'
# planes), bf16, a batch of 4 at 64^2 in 2 microbatches
CARD_KW = dict(num_blocks=1, num_classes=16, dtype=torch.bfloat16, fuse_upsample=True,
               fuse_block=True)
CARD_BATCH, CARD_RES, CARD_M = 4, 64, 2


def card_main(backend: str, work: Path) -> int:
    device = 'cuda:0' if backend == 'gloo' else 'cuda'      # nccl: cuda:LOCAL_RANK
    rank, world = maybe_initialize_distributed(device, backend=backend, timeout=TIMEOUT_S,
                                               verbose=False)
    assert world == 2, world
    mesh = make_mesh(0, 1, device, pipeline_parallel=2)
    # a hand-off: stage 0 sends a CUDA tensor, stage 1 receives it on its card
    link = pipeline._Link(mesh, mesh.device)
    assert link.host == (backend == 'gloo'), (backend, link.host)
    x = torch.arange(2 * 4 * 4 * 8, dtype=torch.float32, device=mesh.device).view(2, 4, 4, 8)
    if mesh.stage == 0:
        link.send(x, 1)
        link.flush()
        handoff = True
    else:
        got = link.recv(0, x.shape, x.dtype)
        handoff = bool(got.device == x.device and torch.equal(got, x))
    torch.manual_seed(0)
    stem, stacks = build_stage(2, mesh, mesh.device, **CARD_KW)
    state = PipelineState.create(stem, stacks, make_optimizer(*LR), mesh, 2)
    ds = Synthetic(True, num_samples=CARD_BATCH, inp_res=CARD_RES, out_res=CARD_RES // 4,
                   sigma=1, scale_factor=0.25, rot_factor=30)
    step = pipeline.make_pipeline_train_step_raw(make_spec(ds), mesh, num_microbatches=CARD_M)
    raw = ds.canvas_batch(range(CARD_BATCH), canvas=CARD_RES)
    tracing.reset()
    state, m = step(state, raw, 0)
    out = dict(stage=mesh.stage, device=str(mesh.device), handoff=handoff,
               loss=float(m['loss']), launches=launch_counts())
    (work / f'card{rank}.json').write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == '__main__':
    if sys.argv[1] == '--card':
        sys.exit(card_main(sys.argv[2], Path(sys.argv[3])))
    sys.exit(main(Path(sys.argv[1])))
