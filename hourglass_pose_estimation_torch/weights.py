"""Carry weights between the JAX package and the port.

The port's submodules are named after the flax module paths, so a JAX
`{'params', 'batch_stats'}` tree maps onto the port's `state_dict` by a
walk: the path joins with '.', and the leaf renames as

  params      kernel [kh, kw, I/groups, O] -> weight [O, I/groups, kh, kw]
              (transpose(3, 2, 0, 1), right for grouped and depthwise
              convs too: both frameworks split channels contiguously)
              bias -> bias, scale -> weight (BatchNorm)
  batch_stats mean -> running_mean, var -> running_var

`to_jax_variables` is the inverse walk, so a trained port model can be
compared leaf by leaf under the flax names. `load_jax_pipeline_variables`
fills a pipeline stage (`HourglassStem` and `HourglassStack`s) from the
JAX pipeline's (stem, stacked) trees. With a (data x model) `mesh`,
`load_jax_variables` fills a tensor-parallel model
(`parallel.tensor_parallel.shard_model`'s) with this rank's slice of each
leaf the rule shards.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_LEAVES = {
    ('params', 'kernel'): 'weight',
    ('params', 'bias'): 'bias',
    ('params', 'scale'): 'weight',
    ('batch_stats', 'mean'): 'running_mean',
    ('batch_stats', 'var'): 'running_var',
}


def _walk(node, path=()):
    for key, val in node.items():
        if isinstance(val, Mapping):
            yield from _walk(val, path + (str(key),))
        else:
            yield path, str(key), val


def load_jax_variables(model: torch.nn.Module, variables, mesh=None) -> torch.nn.Module:
    """Fill `model` in place from a JAX `{'params', 'batch_stats'}` tree
    (nested dicts of numpy arrays). Strict: any leaf without a port
    counterpart, any port tensor left unfilled and any shape mismatch
    raises KeyError listing them all. With a `mesh` whose model axis is
    more than 1, `model` is sharded (`shard_model`) and each tensor takes
    this rank's slice of its leaf (`parallel.shard_params`). Returns the
    model."""
    from hourglass_pose_estimation_torch.parallel.mesh import shard_params
    target = model.state_dict()
    filled, problems = set(), []
    for coll in ('params', 'batch_stats'):
        for path, leaf, val in _walk(variables.get(coll, {})):
            where = '/'.join((coll,) + path + (leaf,))
            name = _LEAVES.get((coll, leaf))
            key = '.'.join(path + (name,)) if name else None
            if key not in target:
                problems.append(f'unexpected {where}')
                continue
            arr = np.array(val, dtype=np.float32)      # a writable copy
            if leaf == 'kernel':
                arr = arr.transpose(3, 2, 0, 1)
            if mesh is not None:
                arr = shard_params({key: torch.from_numpy(arr)}, mesh)[key].numpy()
            if tuple(arr.shape) != tuple(target[key].shape):
                problems.append(f'shape mismatch {where} {arr.shape} vs '
                                f'{key} {tuple(target[key].shape)}')
                continue
            with torch.no_grad():
                target[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(key)
    problems += [f'missing {key}' for key in target if key not in filled]
    if problems:
        raise KeyError(f'JAX variables do not match the model '
                       f'({len(problems)} problems):\n  '
                       + '\n  '.join(problems[:40]))
    return model


def to_jax_variables(model: torch.nn.Module) -> dict:
    """The port model's state as a JAX `{'params', 'batch_stats'}` tree of
    nested dicts of f32 numpy arrays (the inverse of
    `load_jax_variables`: weight [O, I/groups, kh, kw] -> kernel
    [kh, kw, I/groups, O] for convs, weight -> scale for BatchNorms). The
    arrays are copies: later training does not change them."""
    from hourglass_pose_estimation_torch.models.norm import BatchNorm
    out = {'params': {}, 'batch_stats': {}}
    for mod_name, mod in model.named_modules():
        own = list(mod.named_parameters(recurse=False)) + list(
            mod.named_buffers(recurse=False))
        for name, t in own:
            # a copy: .numpy() of a CPU f32 tensor shares its memory
            arr = t.detach().to(torch.float32).cpu().numpy().copy()
            if isinstance(mod, BatchNorm):
                coll, leaf = {'weight': ('params', 'scale'),
                              'bias': ('params', 'bias'),
                              'running_mean': ('batch_stats', 'mean'),
                              'running_var': ('batch_stats', 'var')}[name]
            elif name == 'weight':
                coll, leaf, arr = 'params', 'kernel', arr.transpose(2, 3, 1, 0)
            else:
                coll, leaf = 'params', name
            node = out[coll]
            for part in mod_name.split('.'):
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(arr)
    return out


def load_jax_pipeline_variables(stem: torch.nn.Module, stacks, stem_vars, stacked_vars,
                                indices=None):
    """Fill a pipeline stage in place from the JAX pipeline layout
    (`parallel/pipeline.py::split_hourglass_variables` there, or
    `init_pipeline`'s state): `stem_vars` a `{'params', 'batch_stats'}`
    tree of the stem, `stacked_vars` the stacks' tree whose every leaf has
    a leading [S] stack axis (numpy). stacks[j] takes stack indices[j]
    (default j). Strict, as `load_jax_variables`."""
    indices = range(len(stacks)) if indices is None else indices
    load_jax_variables(stem, stem_vars)
    for stack, i in zip(stacks, indices):
        load_jax_variables(stack, _index_tree(stacked_vars, i))


def _index_tree(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
