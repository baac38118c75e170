"""Train state, optimizer, and the train and eval steps.

Port of `hourglass_pose_estimation_tpu/runner/train_state.py`
(`make_optimizer`, `TrainState`, `init_state`, `make_train_step`,
`make_stage_fn`, `make_overlapped_train_step`, `make_eval_step`). One
train step runs, on the model's device: the augmentation and target
render (device pipeline), the forward, the per-stack weighted MSE, the
backward, the RMSprop update and PCK.

Optimizer: `torch.optim.RMSprop(alpha=0.99, eps=1e-8, momentum=0)`, eps
outside the sqrt (u = g / (sqrt(E[g^2]) + eps)), which is the optax chain
the JAX package configures. Learning rate: the step-indexed piecewise
constant schedule, multiplied by `gamma` from step epoch * steps_per_epoch
on, for each epoch of `schedule_epochs`.

The per-step augmentation generator is seeded from (base seed, step), as
the JAX step folds the step into its key, so two runs from one seed draw
the same augmentations. The state is updated in place and returned.

Data parallelism (`mesh`, from `parallel.make_mesh`, with a process
group): the train step wraps the model in `DistributedDataParallel`, the
implicit path of the JAX package's jit over a sharded batch. Each rank
draws the GLOBAL batch's augmentations from the one step generator and
keeps its rows' slice, so the ranks together take the draws one process
would take on the global batch; the model's BatchNorms sync their
statistics (`norm.sync_batch_norm`, which the Trainer sets), DDP averages
the gradients, and the loss and PCK (from hit and valid counts summed over
the ranks) are the global batch's. The JAX step computes exactly that, so
the ranks' step equals the one-process step on the global batch up to
the order of the sums. DDP keeps its buffers as they are
(`broadcast_buffers=False`): synced statistics are the same on every rank.
The eval step also returns its sums (`loss_sum`, `n`, `hit`, `joints`),
which the Trainer all-reduces.

Under tensor parallelism (a (data x model) mesh and a model of
`parallel.tensor_parallel.shard_model`) the same step runs on every rank:
`mesh.world`/`mesh.rank` are the DATA coordinates, so every model rank of a
data coordinate draws and augments the same rows of the global batch (their
replicated compute stays the same), DDP and the metrics' all-reduce run
over the data group (`mesh.group`), and the sharded layers' collectives
over the model group.

The overlapped step (`make_overlapped_train_step`) stages batch N+1 (the
augmentation and target render of the next raw batch) while it steps
batch N: on the card on a side CUDA stream, ordered before the next step's
use by an event, in sequence on the CPU; the augmentation of the batch a
step consumes at `state.step` = s is drawn from step s's generator, as the
sequential step draws it.

Spans (`utils.tracing`, recorded under a profiler or `tracing.enable()`):
a train step is `train.step` (step `state.step`) around, in order,
`train.stage` (to the device, the draws, the augmentation and render),
`train.forward` (the model and the loss), `train.backward` (zero_grad and
the backward), `train.optimizer` (the lr and RMSprop's step) and
`train.metrics`; the overlapped step's staging is a `train.stage` of its
own, of the step that will consume it, timed on the side stream. No span
goes inside the models.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.data.pipeline import (
    augment_batch, sample_augmentations, to_device)
from hourglass_pose_estimation_torch.loss import heatmap_mse_loss
from hourglass_pose_estimation_torch.utils import tracing
from hourglass_pose_estimation_torch.utils.evaluation import (
    combine_pck_counts, pck_counts)


@dataclasses.dataclass(frozen=True)
class RMSpropSchedule:
    """RMSprop (alpha 0.99, eps 1e-8 outside the sqrt) with a step decay."""
    learning_rate: float
    boundaries: Dict[int, float]     # step -> factor applied from that step

    def lr(self, step: int) -> float:
        v = self.learning_rate
        for boundary, scale in sorted(self.boundaries.items()):
            if step >= boundary:
                v *= scale
        return v

    def build(self, params) -> torch.optim.RMSprop:
        return torch.optim.RMSprop(params, lr=self.learning_rate, alpha=0.99,
                                   eps=1e-8, momentum=0, weight_decay=0)


def make_optimizer(learning_rate: float, schedule_epochs: Sequence[int],
                   gamma: float, steps_per_epoch: int) -> RMSpropSchedule:
    """RMSprop + epoch-boundary step decay (reference parity)."""
    return RMSpropSchedule(
        float(learning_rate),
        {int(e) * int(steps_per_epoch): float(gamma) for e in schedule_epochs})


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    tx: RMSpropSchedule
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the DistributedDataParallel wrapper of `model` that the data-parallel
    # steps share, made at its first step
    ddp: Any = None


def init_state(model: torch.nn.Module, tx: RMSpropSchedule) -> TrainState:
    """A TrainState over `model`'s parameters (on the model's device)."""
    return TrainState(model=model, tx=tx,
                      optimizer=tx.build(list(model.parameters())))


def step_generator(rng: int, step: int, device, rank=None) -> torch.Generator:
    """The augmentation generator of step `step` under base seed `rng`; with
    `rank`, that rank's own stream (the explicit step's, as the JAX one
    folds the shard index into its key before the step)."""
    key = (int(rng), int(step)) if rank is None else (int(rng), int(rank), int(step))
    seed = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _select_subset(target, tw, subset):
    if subset is None:
        return target, tw
    idx = torch.as_tensor(subset, dtype=torch.int64, device=target.device)
    return target[..., idx], tw[:, idx]


def _global_draws(spec, rng: int, step: int, scales: torch.Tensor, mesh):
    """This rank's rows of the global batch's draws from the step's
    generator (all of them without a mesh)."""
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
    b = scales.shape[0]
    scales_a, rots, flips = sample_augmentations(
        step_generator(rng, step, scales.device), scales.repeat(world, 1),
        scale_factor=spec.scale_factor, rot_factor=spec.rot_factor, train=True)
    rows = slice(rank * b, (rank + 1) * b)
    return scales_a[rows], rots[rows], flips[rows]


def step_metrics(loss: torch.Tensor, heatmaps: torch.Tensor, target: torch.Tensor,
                 pck_thr: float, mesh=None) -> dict:
    """{'loss', 'acc'} of a step: with a process group, the mean of the
    ranks' losses and the PCK of the hit and valid counts summed over the
    ranks (one all-reduce), the global batch's."""
    hit, nv = pck_counts(heatmaps, target, thr=pck_thr)
    if mesh is None or mesh.group is None:
        return {'loss': loss.detach(), 'acc': combine_pck_counts(hit, nv)[0]}
    v = torch.cat([loss.detach().reshape(1).double(), hit.double(), nv.double()])
    dist.all_reduce(v, group=mesh.group)
    J = hit.numel()
    acc = combine_pck_counts(v[1:1 + J].float(), v[1 + J:].float())[0]
    return {'loss': (v[0] / mesh.world).to(loss.dtype), 'acc': acc}


def _replica(state: TrainState, mesh):
    """The state's DistributedDataParallel wrapper over the mesh's data
    group (under tensor parallelism the ranks of this model coordinate)."""
    if state.ddp is None or state.ddp.module is not state.model:
        from torch.nn.parallel import DistributedDataParallel as DDP
        dev = mesh.device
        # no buffer sync before each forward (forward_sync_buffers since
        # PyTorch 2.13, broadcast_buffers before)
        keep = ('forward_sync_buffers' if 'forward_sync_buffers'
                in inspect.signature(DDP).parameters else 'broadcast_buffers')
        state.ddp = DDP(state.model, device_ids=[dev.index] if dev.type == 'cuda' else None,
                        process_group=mesh.group, **{keep: False})
    return state.ddp


def make_train_step(spec, *, subset=None, pck_thr=0.5, device_pipeline=True,
                    freeze_bn=False, mesh=None):
    """The train step.

      device pipeline: (state, raw_batch, rng) -> (state, metrics), with
        raw_batch from `PoseDataset.canvas_batch` and rng an int base seed;
      host pipeline:   (state, batch, rng) -> (state, metrics), batch with
        'image' (normalised), 'target', 'target_weight'.

    metrics = {'loss', 'acc'} as 0-d tensors on the device.
    freeze_bn=True normalises with the running BatchNorm averages (the
    model's eval-mode forward, so fused bottlenecks run there) and leaves
    them unchanged; the parameters still train. With a `mesh` whose process
    group is initialized, the batch is this rank's rows of the global batch
    and the step is data-parallel (DDP, see the module docstring)."""
    subset_t = tuple(subset) if subset is not None else None
    distributed = mesh is not None and mesh.group is not None

    def train_step(state: TrainState, batch, rng):
        dev = _device_of(state)
        with tracing.span('train.step', step=state.step, device=dev):
            with tracing.span('train.stage'):
                data = to_device(batch, dev)
                if device_pipeline:
                    data = augment_batch(
                        data, _global_draws(spec, rng, state.step, data['scale'], mesh), spec,
                        True)
                target, tw = _select_subset(data['target'], data['target_weight'], subset_t)
            with tracing.span('train.forward'):
                model = _replica(state, mesh) if distributed else state.model
                outs = model(data['image'], train=not freeze_bn)
                loss = heatmap_mse_loss(outs, target, tw)
            with tracing.span('train.backward'):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with tracing.span('train.optimizer'):
                for group in state.optimizer.param_groups:
                    group['lr'] = state.tx.lr(state.step)
                state.optimizer.step()
            with tracing.span('train.metrics'), torch.no_grad():
                metrics = step_metrics(loss, outs[-1], target, pck_thr, mesh)
            state.step += 1
        return state, metrics

    return train_step


# keys of a staged (augmented) batch as the model and the loss consume it
STAGED_KEYS = ('image', 'target', 'target_weight')


def _stage(spec, batch, rng: int, step: int, train: bool, device) -> dict:
    # the span's events go on the stream the staging runs on (the
    # overlapped step's side stream)
    with tracing.span('train.stage', step=step, device=device):
        data = to_device(batch, device)
        draws = (_global_draws(spec, rng, step, data['scale'], None) if train else
                 sample_augmentations(None, data['scale'], scale_factor=spec.scale_factor,
                                      rot_factor=spec.rot_factor, train=False))
        data = augment_batch(data, draws, spec, train)
        return {k: data[k] for k in STAGED_KEYS}


def make_stage_fn(spec, *, train=True, device='cuda'):
    """The augment-only step that primes the overlapped step:
    stage(raw_batch, rng, step) -> {'image', 'target', 'target_weight'} on
    `device` (the card unless the caller asks for the CPU), drawn from step
    `step`'s generator (`step_generator`), as the train step draws them,
    so the overlapped and the sequential steps consume one augmentation
    stream."""
    dev = resolve_device(device)

    def stage(batch, rng, step):
        return _stage(spec, batch, rng, step, train, dev)

    return stage


def make_overlapped_train_step(spec, *, subset=None, pck_thr=0.5):
    """The train step that stages the next batch while it steps this one:
    (state, staged, raw_next, rng) -> (state, staged_next, metrics).

    `staged` is batch N, staged by `make_stage_fn` or by the previous call,
    and is stepped by make_train_step(spec, device_pipeline=False); raw_next
    is the next raw canvas batch, augmented (draws from step state.step +
    1's generator) and its targets rendered on a side CUDA stream that the
    step's forward and backward on the current stream do not wait for; the
    current stream waits for the staging (an event) only when this call
    returns, and the staged tensors are marked as used on it
    (`record_stream`), so the allocator keeps them until the next step is
    done with them. On the CPU the staging runs first, in sequence. The
    kernels of the staging (the render, the warp's ops) launch on the side
    stream they are given. Drain the last staged batch with
    make_train_step(spec, device_pipeline=False)."""
    step = make_train_step(spec, subset=subset, pck_thr=pck_thr, device_pipeline=False)
    side = {}

    def train_step(state: TrainState, staged, raw_next, rng):
        dev = _device_of(state)
        if dev.type != 'cuda':
            nxt = _stage(spec, raw_next, rng, state.step + 1, True, dev)
            state, metrics = step(state, staged, rng)
            return state, nxt, metrics
        if dev not in side:
            side[dev] = torch.cuda.Stream(dev)
        stream = side[dev]
        with torch.cuda.stream(stream):
            nxt = _stage(spec, raw_next, rng, state.step + 1, True, dev)
            ready = torch.cuda.Event()
            ready.record(stream)
        state, metrics = step(state, staged, rng)
        current = torch.cuda.current_stream(dev)
        current.wait_event(ready)
        for t in nxt.values():
            t.record_stream(current)
        return state, nxt, metrics

    return train_step


def make_eval_step(spec, *, subset=None, pck_thr=0.5, device_pipeline=True):
    """Eval step: (state, batch, valid [B]) -> {'loss', 'acc', 'per_joint',
    'n', 'loss_sum', 'hit', 'joints'}; forward with the running BN averages,
    no state change. `valid` masks padded tail samples out (weights and
    targets zeroed) and the loss is rescaled by B/n to a mean over the
    valid samples. The sums, `loss_sum` (loss * n) and the per-joint PCK
    hit and valid counts, are what ranks all-reduce."""
    subset_t = tuple(subset) if subset is not None else None

    @torch.no_grad()
    def eval_step(state: TrainState, batch, valid):
        dev = _device_of(state)
        data = to_device(batch, dev)
        valid = (valid if isinstance(valid, torch.Tensor)
                 else torch.as_tensor(np.asarray(valid))).to(dev, torch.float32)
        if device_pipeline:
            draws = sample_augmentations(
                None, data['scale'], scale_factor=spec.scale_factor,
                rot_factor=spec.rot_factor, train=False)
            data = augment_batch(data, draws, spec, False)
        target, tw = _select_subset(data['target'], data['target_weight'], subset_t)
        tw = tw * valid[:, None]
        target = target * valid[:, None, None, None]
        outs = state.model(data['image'], train=False)
        n = valid.sum().clamp_min(1.0)
        loss = heatmap_mse_loss(outs, target, tw) * (data['image'].shape[0] / n)
        hit, joints = pck_counts(outs[-1], target, thr=pck_thr)
        acc, per_joint, _ = combine_pck_counts(hit, joints)
        return {'loss': loss, 'acc': acc, 'per_joint': per_joint, 'n': valid.sum(),
                'loss_sum': loss.double() * valid.sum(), 'hit': hit, 'joints': joints}

    return eval_step
