"""Train state, optimizer, and the train and eval steps.

Port of `hourglass_pose_estimation_tpu/runner/train_state.py`
(`make_optimizer`, `TrainState`, `init_state`, `make_train_step`,
`make_eval_step`). One train step runs, on the model's device: the
augmentation and target render (device pipeline), the forward, the
per-stack weighted MSE, the backward, the RMSprop update and PCK.

Optimizer: `torch.optim.RMSprop(alpha=0.99, eps=1e-8, momentum=0)`, eps
outside the sqrt (u = g / (sqrt(E[g^2]) + eps)), which is the optax chain
the JAX package configures. Learning rate: the step-indexed piecewise
constant schedule, multiplied by `gamma` from step epoch * steps_per_epoch
on, for each epoch of `schedule_epochs`.

The per-step augmentation generator is seeded from (base seed, step), as
the JAX step folds the step into its key, so two runs from one seed draw
the same augmentations. The state is updated in place and returned.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from hourglass_pose_estimation_torch.data.pipeline import (
    augment_batch, sample_augmentations, to_device)
from hourglass_pose_estimation_torch.loss import heatmap_mse_loss
from hourglass_pose_estimation_torch.utils.evaluation import accuracy


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


def init_state(model: torch.nn.Module, tx: RMSpropSchedule) -> TrainState:
    """A TrainState over `model`'s parameters (on the model's device)."""
    return TrainState(model=model, tx=tx,
                      optimizer=tx.build(list(model.parameters())))


def step_generator(rng: int, step: int, device) -> torch.Generator:
    """The augmentation generator of step `step` under base seed `rng`."""
    seed = np.random.SeedSequence((int(rng), int(step))).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _select_subset(target, tw, subset):
    if subset is None:
        return target, tw
    idx = torch.as_tensor(subset, dtype=torch.int64, device=target.device)
    return target[..., idx], tw[:, idx]


def make_train_step(spec, *, subset=None, pck_thr=0.5, device_pipeline=True,
                    freeze_bn=False):
    """The train step.

      device pipeline: (state, raw_batch, rng) -> (state, metrics), with
        raw_batch from `PoseDataset.canvas_batch` and rng an int base seed;
      host pipeline:   (state, batch, rng) -> (state, metrics), batch with
        'image' (normalised), 'target', 'target_weight'.

    metrics = {'loss', 'acc'} as 0-d tensors on the device.
    freeze_bn=True normalises with the running BatchNorm averages (the
    model's eval-mode forward, so fused bottlenecks run there) and leaves
    them unchanged; the parameters still train."""
    subset_t = tuple(subset) if subset is not None else None

    def train_step(state: TrainState, batch, rng):
        dev = _device_of(state)
        data = to_device(batch, dev)
        if device_pipeline:
            draws = sample_augmentations(
                step_generator(rng, state.step, dev), data['scale'],
                scale_factor=spec.scale_factor, rot_factor=spec.rot_factor,
                train=True)
            data = augment_batch(data, draws, spec, True)
        target, tw = _select_subset(data['target'], data['target_weight'], subset_t)
        outs = state.model(data['image'], train=not freeze_bn)
        loss = heatmap_mse_loss(outs, target, tw)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.optimizer.param_groups:
            group['lr'] = state.tx.lr(state.step)
        state.optimizer.step()
        with torch.no_grad():
            acc, _, _ = accuracy(outs[-1], target, thr=pck_thr)
        state.step += 1
        return state, {'loss': loss.detach(), 'acc': acc}

    return train_step


def make_eval_step(spec, *, subset=None, pck_thr=0.5, device_pipeline=True):
    """Eval step: (state, batch, valid [B]) -> {'loss', 'acc', 'per_joint',
    'n'}; forward with the running BN averages, no state change. `valid`
    masks padded tail samples out (weights and targets zeroed) and the
    loss is rescaled by B/n to a mean over the valid samples."""
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
        acc, per_joint, _ = accuracy(outs[-1], target, thr=pck_thr)
        return {'loss': loss, 'acc': acc, 'per_joint': per_joint,
                'n': valid.sum()}

    return eval_step
