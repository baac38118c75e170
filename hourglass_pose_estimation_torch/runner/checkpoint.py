"""Checkpoints of {train state, epoch, best metric}.

Port of `hourglass_pose_estimation_tpu/runner/checkpoint.py` (Orbax there):
the same payload, the model's parameters and BatchNorm statistics, the
optimizer state, `step`, `epoch` and `best_acc`, as one `torch.save` file of
tensors and plain numbers, read back with `torch.load(weights_only=True)`
(no pickled objects). A save writes a temporary file beside the target and
renames it over the target, so a crash leaves the last snapshot whole.

Under data parallelism (a process group) rank 0 writes, then every rank
meets at a barrier, so no rank goes on to read a checkpoint that is not
whole; every rank restores from the file. A pipeline-parallel state
(`parallel.pipeline.PipelineState`) is saved merged, in the standard
layout, with its optimizer state as {'stem', 'stack'} (the JAX Trainer's
`_ckpt_view`): every rank takes part in gathering it (`checkpoint_state`,
a collective), rank 0 writes it, and a resume splits it again
(`restore_state`). A tensor-parallel state (`parallel.tensor_parallel.
ShardedTrainState`) is saved in the standard layout too, its parameters,
statistics and RMSprop accumulators gathered over the model group, and a
resume shards it again (JAX `_place_state`): a checkpoint of a run with or
without tensor parallelism resumes the other.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch.runner.train_state import TrainState


def save(path: str, state: TrainState, epoch: int, best_acc: float) -> None:
    """Save state + metadata as the file `path` (rank 0's, then a barrier
    of every rank, under a process group); `state` is a TrainState, a
    ShardedTrainState or a PipelineState."""
    distributed = dist.is_available() and dist.is_initialized()
    if hasattr(state, 'checkpoint_state'):
        model, optimizer = state.checkpoint_state()
    else:
        model, optimizer = state.model.state_dict(), state.optimizer.state_dict()
    if not distributed or dist.get_rank() == 0:
        _write(path, {
            'model': model,
            'optimizer': optimizer,
            'step': int(state.step),
            'epoch': int(epoch),
            'best_acc': float(best_acc),
        })
    if distributed:
        dist.barrier()


def _write(path: str, payload: dict) -> None:
    path = os.path.abspath(path)
    tmp = f'{path}.tmp{os.getpid()}'
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(path: str, device) -> Dict[str, Any]:
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def _check_optimizer_layout(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """Raise ValueError unless `saved` (an optimizer state_dict) has this
    optimizer's parameter groups and per-parameter state shapes:
    `load_state_dict` checks only the group sizes."""
    groups = optimizer.param_groups
    if len(groups) != len(saved['param_groups']):
        raise ValueError('optimizer has another number of parameter groups')
    for g, sg in zip(groups, saved['param_groups']):
        if len(g['params']) != len(sg['params']):
            raise ValueError('optimizer parameter group of another size')
        for p, i in zip(g['params'], sg['params']):
            for name, t in saved['state'].get(i, {}).items():
                if (isinstance(t, torch.Tensor) and t.dim() > 0
                        and t.shape != p.shape):
                    raise ValueError(f'optimizer state {name} of parameter {i}: '
                                     f'{tuple(t.shape)} != {tuple(p.shape)}')


def load_optimizer(optimizer: torch.optim.Optimizer, saved: Optional[dict], tx,
                   params) -> torch.optim.Optimizer:
    """`optimizer` with the state `saved` loaded; when `saved` is of
    another layout (another optimizer, another parameter grouping, a
    pipeline checkpoint's two states, or None), a fresh optimizer of the
    rule `tx` over `params`, and a printed line."""
    try:
        if saved is None:
            raise KeyError('no optimizer state of this layout')
        _check_optimizer_layout(optimizer, saved)
        optimizer.load_state_dict(saved)
        return optimizer
    except (ValueError, KeyError, TypeError) as e:
        print('=> checkpoint optimizer layout differs from this run '
              f'({type(e).__name__}); restored params/stats only '
              '(fresh optimizer state)', flush=True)
        return tx.build(list(params))


def restore(path: str, state: TrainState) -> Dict[str, Any]:
    """Restore into `state` (a TrainState: its model and optimizer, in
    place, on the model's device; a ShardedTrainState, sharded; or a
    PipelineState, split) -> {'state', 'epoch', 'best_acc'}.

    An optimizer state of another layout (another optimizer, another
    parameter grouping, the other of the standard and pipeline layouts)
    gives a fresh optimizer, with the parameters, statistics and step
    restored and a printed line. A file that does not load, or whose model
    state does not match, raises its own error."""
    module = state.stem if hasattr(state, 'stem') else state.model
    payload = _load(path, next(module.parameters()).device)
    if hasattr(state, 'restore_state'):
        state.restore_state(payload['model'], payload['optimizer'])
    else:
        state.model.load_state_dict(payload['model'])
        state.optimizer = load_optimizer(state.optimizer, payload['optimizer'], state.tx,
                                         state.model.parameters())
    state.step = int(payload['step'])
    return {'state': state, 'epoch': int(payload['epoch']),
            'best_acc': float(payload['best_acc'])}


def restore_params(path: str, device='cpu') -> Dict[str, torch.Tensor]:
    """Only the model's parameters and BatchNorm statistics (its
    `state_dict`), for inference-side loading."""
    return _load(path, device)['model']
