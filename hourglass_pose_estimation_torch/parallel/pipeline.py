"""Pipeline parallelism over hourglass stacks (GPipe over processes).

Port of `hourglass_pose_estimation_tpu/parallel/pipeline.py`. The stacked
hourglass is a chain, stem -> stack_0 -> ... -> stack_{S-1}, each stack
giving its intermediate-supervision heatmaps and handing its 256-channel
features on. The stacks are split over the pipe axis of the (data x pipe)
layout (`parallel/mesh.py`): stage p holds stacks [p*k, (p+1)*k), k = S/P,
and every stage holds the stem (replicated, stage 0 alone runs it). The
JAX step is one masked SPMD `lax.scan` of M + P - 1 ticks inside
`shard_map`, whose backward autodiff derives; here each rank runs its own
GPipe schedule: M forwards in microbatch order, then M backwards in
reverse, each stage receiving its input from stage p - 1 and sending its
output to p + 1 (the last stage sends nothing: JAX's ring sends it to stage
0, which ignores it), and sending the gradient of its input back. The two
compute the same step:

  * BatchNorm takes its statistics per microbatch, from the microbatch's
    first `bn_stat_samples` rows, unsynced; the running averages move once
    per microbatch, in microbatch order (M momentum updates a step), for
    the stem on stage 0 and for each stack. After the step the stem's are
    stage 0's, broadcast over the pipe group, and every statistic is
    averaged over the data group.
  * The local loss is sum_m heatmap_mse_loss(the stage's scores, target_m,
    weight_m) / M; the reported loss is its sum over the pipe group,
    averaged over the data group (the sequential model's loss on the
    rank's rows: equal microbatches average to the batch mean). PCK is
    the mean over microbatches of `accuracy(last stack's scores)[0]` on
    the last stage, averaged over the data group: the JAX pipeline's mean
    of per-microbatch accuracies, not `step_metrics`' PCK from summed hit
    and valid counts.
  * Stem gradients are summed over the pipe group (stage 0's alone are not
    zero) and averaged over the data group; stack gradients are averaged
    over the data group; one RMSprop rule (`state.tx`, as two torch
    optimizers, JAX's two optax states) steps the stem and the stage's
    stacks.

Those reductions take two all-reduces a step: one over every rank (the
stem's gradients and statistics and the metrics: a sum over the pipe
group then a mean over the data group is a sum over the world divided by
the data size) and one over the data group (the stacks'); a group of one
rank skips its own.

Transport: `dist.batch_isend_irecv` on the pipe group. Over NCCL the
hand-offs are the CUDA tensors; gloo's send and recv take CPU tensors
only, so over gloo (the CPU, and several ranks on one card) each hand-off
is staged through host memory explicitly, as the group's backend says.
Features go as [mb, h, w, C] channels-last buffers.

`pipeline_specs` and `shard_pipeline_state` have no counterpart: each
rank holds its stage's modules (`PipelineState`), and the data is this
data rank's rows (as the JAX batch is sharded over 'data' and replicated
over 'pipe').
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from hourglass_pose_estimation_torch.data.pipeline import augment_batch, to_device
from hourglass_pose_estimation_torch.loss import heatmap_mse_loss
from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.models.hourglass import (
    STACK_NAMES, STEM_NAMES, HourglassNet, HourglassStack, HourglassStem)
from hourglass_pose_estimation_torch.models.norm import BatchNorm, running_stats_frozen
from hourglass_pose_estimation_torch.parallel.shard_map_step import all_reduce_
from hourglass_pose_estimation_torch.runner.checkpoint import load_optimizer
from hourglass_pose_estimation_torch.runner.train_state import (
    RMSpropSchedule, _global_draws, _select_subset)
from hourglass_pose_estimation_torch.utils.evaluation import accuracy

FEEDBACK = ('fc_back', 'score_back')
_STACK_KEY = re.compile('(' + '|'.join(STACK_NAMES) + r')(\d+)')
# the stem's keyword arguments (the stack takes each of them, and more)
STEM_KWARGS = ('num_feats', 'mobile', 'dtype', 'bn_stat_samples', 'bn_fast_variance',
               'fuse_upsample', 'fuse_block')


def split_hourglass_variables(state_dict: Dict[str, torch.Tensor], num_stacks: int):
    """A HourglassNet state_dict -> (the stem's state_dict, [each stack's
    state_dict]), the port of JAX `split_hourglass_variables`: conv1, bn1
    and layer1-3 go to the stem, hg{i}, res{i}, ... to stack i under their
    names less the index. The last stack's feedback convs, which
    HourglassNet lacks, are zero-filled (the schedule drops their
    output)."""
    stem, stacks = {}, [{} for _ in range(num_stacks)]
    for key, value in state_dict.items():
        head, rest = key.split('.', 1)
        if head in STEM_NAMES:
            stem[key] = value
            continue
        m = _STACK_KEY.fullmatch(head)
        if m is None or int(m.group(2)) >= num_stacks:
            raise KeyError(f'{key}: not a HourglassNet of {num_stacks} stacks')
        stacks[int(m.group(2))][f'{m.group(1)}.{rest}'] = value
    last = stacks[-1]
    fc_w, fc_b, score_w = last['fc.weight'], last['fc.bias'], last['score.weight']
    last.setdefault('fc_back.weight', fc_w.new_zeros(fc_w.shape))
    last.setdefault('fc_back.bias', fc_b.new_zeros(fc_b.shape))
    last.setdefault('score_back.weight', fc_w.new_zeros((fc_w.shape[0], score_w.shape[0], 1, 1)))
    last.setdefault('score_back.bias', fc_b.new_zeros(fc_b.shape))
    return stem, stacks


def merge_hourglass_variables(stem: Dict[str, torch.Tensor],
                              stacks: Sequence[Dict[str, torch.Tensor]], num_stacks: int):
    """The inverse of `split_hourglass_variables`: the HourglassNet
    state_dict (stack i's names indexed again, the last stack's feedback
    convs dropped), what every standard tool reads (the eval step,
    checkpoints, export, the estimator)."""
    out = dict(stem)
    for i, sd in enumerate(stacks):
        for key, value in sd.items():
            name, rest = key.split('.', 1)
            if not (i == num_stacks - 1 and name in FEEDBACK):
                out[f'{name}{i}.{rest}'] = value
    return out


@dataclasses.dataclass
class PipelineState:
    """This rank's stage: the stem (every stage holds it), its k stacks
    (stacks stage*k .. stage*k + k - 1), the RMSprop rule and one torch
    optimizer each for the stem and the stacks (the JAX state's two optax
    states), the step, and the layout."""
    stem: nn.Module
    stacks: nn.ModuleList
    tx: RMSpropSchedule
    opt_stem: torch.optim.Optimizer
    opt_stack: torch.optim.Optimizer
    mesh: object
    num_stacks: int
    step: int = 0

    @classmethod
    def create(cls, stem: nn.Module, stacks: Sequence[nn.Module], tx: RMSpropSchedule,
               mesh, num_stacks: int) -> 'PipelineState':
        stacks = nn.ModuleList(stacks)
        return cls(stem=stem, stacks=stacks, tx=tx, opt_stem=tx.build(list(stem.parameters())),
                   opt_stack=tx.build(list(stacks.parameters())), mesh=mesh,
                   num_stacks=num_stacks)

    @property
    def first_stack(self) -> int:
        return self.mesh.stage * len(self.stacks)

    def load_hourglass_state(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load a HourglassNet state_dict, split: the stem and this stage's
        stacks."""
        stem, stacks = split_hourglass_variables(state_dict, self.num_stacks)
        self.stem.load_state_dict(stem)
        for j, stack in enumerate(self.stacks):
            stack.load_state_dict(stacks[self.first_stack + j])

    def hourglass_state(self) -> Dict[str, torch.Tensor]:
        """The merged HourglassNet state_dict (on the CPU), the stacks
        gathered over the pipe group: a collective of the pipe group."""
        stacks = _gather_stage(self.mesh, [_cpu(s.state_dict()) for s in self.stacks])
        return merge_hourglass_variables(_cpu(self.stem.state_dict()), stacks, self.num_stacks)

    def checkpoint_state(self):
        """(the merged HourglassNet state_dict, the optimizer state as
        {'stem', 'stack'}: the stem's, and one optimizer state over every
        stack's parameters in stack order), as JAX `_ckpt_view`: a
        collective of the pipe group."""
        n = _stage_params(self)
        opt = _cpu(self.opt_stack.state_dict())
        opts = _gather_stage(self.mesh, [opt])
        stack = {'state': {p * n + i: st for p, o in enumerate(opts)
                           for i, st in o['state'].items()},
                 'param_groups': [dict(g, params=list(range(len(opts) * n)))
                                  for g in opt['param_groups']]}
        return self.hourglass_state(), {'stem': _cpu(self.opt_stem.state_dict()), 'stack': stack}

    def restore_state(self, model: Dict[str, torch.Tensor], optimizer) -> None:
        """Load a checkpoint's merged model and its optimizer state, split;
        an optimizer state of another layout (a standard checkpoint's)
        gives fresh optimizers (`checkpoint.load_optimizer`)."""
        self.load_hourglass_state(model)
        n, p = _stage_params(self), self.mesh.stage
        stem = stack = None
        if isinstance(optimizer, dict) and {'stem', 'stack'} <= optimizer.keys():
            stem, full = optimizer['stem'], optimizer['stack']
            stack = {'state': {i - p * n: st for i, st in full['state'].items()
                               if p * n <= i < (p + 1) * n},
                     'param_groups': [dict(g, params=list(range(n)))
                                      for g in full['param_groups']]}
        self.opt_stem = load_optimizer(self.opt_stem, stem, self.tx, self.stem.parameters())
        self.opt_stack = load_optimizer(self.opt_stack, stack, self.tx,
                                        self.stacks.parameters())


def _cpu(tree):
    """A copy on the CPU (never a view of the live tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree


def _stage_params(state: PipelineState) -> int:
    return sum(1 for _ in state.stacks.parameters())


def _gather_stage(mesh, items: list) -> list:
    """Every stage's `items` in stage order (this stage's alone without a
    pipe group)."""
    if mesh.pipe_group is None:
        return items
    out = [None] * mesh.pipe
    dist.all_gather_object(out, items, group=mesh.pipe_group)
    return [x for stage in out for x in stage]


def _stacks_per_stage(num_stacks: int, mesh) -> int:
    if num_stacks % mesh.pipe:
        raise ValueError(f'num_stacks {num_stacks} not divisible by pipeline_parallel '
                         f'{mesh.pipe}')
    return num_stacks // mesh.pipe


def _stem(kwargs: dict) -> HourglassStem:
    return HourglassStem(**{n: v for n, v in kwargs.items() if n in STEM_KWARGS})


def _place(module: nn.Module, device) -> nn.Module:
    return module.to(device, memory_format=torch.channels_last)


def stage_of(net: HourglassNet, mesh) -> Tuple[HourglassStem, List[HourglassStack]]:
    """The stem and this stage's k = S / pipe stacks of `net`
    (`HourglassStem.of`, `HourglassStack.of`): they hold `net`'s own
    modules, so the model a config builds (`models.model_from_config`) is
    the one the stage trains, with no second copy of its weights."""
    k = _stacks_per_stage(net.num_stacks, mesh)
    return HourglassStem.of(net), [HourglassStack.of(net, i)
                                   for i in range(mesh.stage * k, (mesh.stage + 1) * k)]


def build_stage(num_stacks: int, mesh, device=None,
                **kwargs) -> Tuple[nn.Module, List[nn.Module]]:
    """The stem and this stage's k = num_stacks / pipe stacks, built with
    `kwargs` (HourglassStack's, `depth` among them; the stem takes those it
    knows) on `device` (None: the mesh's) in channels-last memory; their
    weights are for the caller to load (`weights.load_jax_pipeline_variables`
    carries JAX's)."""
    k = _stacks_per_stage(num_stacks, mesh)
    device = mesh.device if device is None else resolve_device(device)
    return _place(_stem(kwargs), device), [_place(HourglassStack(**kwargs), device)
                                           for _ in range(k)]


def init_pipeline(num_stacks: int, tx: RMSpropSchedule, mesh, generator: torch.Generator,
                  device=None, **kwargs) -> PipelineState:
    """A fresh PipelineState for this rank's stage on `device` (None: the
    mesh's, the card unless the mesh is on the CPU), with weights drawn
    from `generator` (the stem's, then stack 0's .. stack S-1's, on every
    stage, so that the stages hold one model; the global generator is left
    as it was). kwargs: HourglassStack's (num_feats, num_blocks,
    num_classes, mobile, skip_mode, depth, dtype, out_dtype,
    bn_stat_samples, bn_fast_variance, fuse_upsample, fuse_block)."""
    k = _stacks_per_stage(num_stacks, mesh)
    device = mesh.device if device is None else resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.set_state(generator.get_state())
        stem = _stem(kwargs)
        stacks = [HourglassStack(**kwargs) for _ in range(num_stacks)]
        generator.set_state(torch.default_generator.get_state())
    return PipelineState.create(_place(stem, device),
                                [_place(s, device) for s in stacks[mesh.stage * k:][:k]],
                                tx, mesh, num_stacks)


class _Link:
    """The hand-offs of one step between this stage and its neighbours, on
    the pipe group: through host memory over gloo, device to device over
    NCCL. `seconds` adds up the host time spent in them (a send's wait for
    the tensor it copies to the host included)."""

    def __init__(self, mesh, device: torch.device):
        self.group, self.device = mesh.pipe_group, device
        self.base = mesh.rank * mesh.pipe        # the process rank of stage 0
        self.host = dist.get_backend(self.group) == 'gloo'
        self.sends, self.seconds = [], 0.0

    def send(self, x: torch.Tensor, stage: int) -> None:
        """Send an [N, h, w, C] tensor to `stage`."""
        t0 = time.perf_counter()
        buf = x.detach().contiguous()
        if self.host:
            buf = buf.cpu()
        self.sends.append((dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, buf, self.base + stage, self.group)]), buf))
        self.seconds += time.perf_counter() - t0

    def recv(self, stage: int, shape, dtype) -> torch.Tensor:
        """An [N, h, w, C] tensor from `stage`."""
        t0 = time.perf_counter()
        buf = torch.empty(shape, dtype=dtype, device='cpu' if self.host else self.device)
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.irecv, buf, self.base + stage, self.group)]):
            req.wait()
        out = buf.to(self.device) if self.host else buf
        self.seconds += time.perf_counter() - t0
        return out

    def flush(self) -> None:
        t0 = time.perf_counter()
        for reqs, _ in self.sends:
            for req in reqs:
                req.wait()
        self.sends = []
        self.seconds += time.perf_counter() - t0


def _bn_buffers(module: nn.Module) -> List[torch.Tensor]:
    return [t for m in module.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def make_pipeline_train_step(mesh, *, num_microbatches: int, train: bool = True,
                             update: bool = True, pck_thr: float = 0.5):
    """The pipelined step (state, images, target, tw) -> (state, metrics)
    over `mesh` (`parallel.make_mesh(..., pipeline_parallel=P)`), the port
    of JAX `make_pipeline_train_step`: images [B, H, W, 3], target [B, h,
    w, J] and tw [B, J] are this data rank's rows (the same on every stage
    of it), B divisible by `num_microbatches`. The modules run are the
    state's (the port's state holds its modules, as TrainState holds its
    model). train=False normalises with the running averages (then the
    step equals the sequential model's); update=False leaves the state as
    it is (the running averages too) and returns the gradients in the
    metrics, `g_stem` (name -> tensor, the same on every rank) and
    `g_stack` (one such dict for each of the stage's stacks), as the JAX
    parity mode does. metrics: 'loss', 'acc' (0-d tensors, the same on
    every rank) and 'handoff_s' (this rank's host seconds in hand-offs)."""
    M = num_microbatches

    def step(state: PipelineState, images, target, tw):
        P, p = mesh.pipe, mesh.stage
        first, last = p == 0, p == P - 1
        B = images.shape[0]
        if B % M:
            raise ValueError(f'batch {B} does not divide into {M} microbatches')
        mb = B // M
        imgs, tgts, tws = images.split(mb), target.split(mb), tw.split(mb)
        stem, stacks = state.stem, state.stacks
        dev = next(stem.parameters()).device
        feat = (mb, images.shape[1] // 4, images.shape[2] // 4, stem.out_channels)
        link = _Link(mesh, dev) if P > 1 else None
        for opt in (state.opt_stem, state.opt_stack):
            opt.zero_grad(set_to_none=True)
        held, loss_sum, acc_sum = [], 0.0, 0.0
        with running_stats_frozen(stem, frozen=not update), \
                running_stats_frozen(stacks, frozen=not update):
            for m in range(M):
                if first:
                    x_in = h = stem(imgs[m], train=train)
                else:
                    # the received features: a leaf whose gradient goes back
                    x_in = link.recv(p - 1, feat, stem.compute_dtype).requires_grad_(True)
                    h = x_in.permute(0, 3, 1, 2)
                scores = []
                for stack in stacks:
                    score, h = stack(h, train=train)
                    scores.append(score)
                loss = heatmap_mse_loss(torch.stack(scores), tgts[m], tws[m])
                if not last:
                    link.send(h.permute(0, 2, 3, 1), p + 1)
                else:
                    acc_sum = acc_sum + accuracy(scores[-1].float(), tgts[m], thr=pck_thr)[0]
                held.append((x_in, h, loss))
                loss_sum = loss_sum + loss.detach()
        if link is not None:
            link.flush()
        for m in reversed(range(M)):
            x_in, h, loss = held.pop()
            outs, grads = [loss / M], [None]
            if not last:
                outs.append(h)
                grads.append(link.recv(p + 1, feat, h.dtype).permute(0, 3, 1, 2))
            torch.autograd.backward(outs, grads)
            if not first:
                link.send(x_in.grad, p - 1)
        if link is not None:
            link.flush()

        stem_params, stack_params = list(stem.parameters()), list(stacks.parameters())
        with torch.no_grad():
            for t in stem_params + stack_params:
                if t.grad is None:           # the stem off stage 0, the last feedback convs
                    t.grad = torch.zeros_like(t)
            dt = stem_params[0].dtype
            metrics = torch.stack([torch.as_tensor(loss_sum / M, dtype=dt, device=dev),
                                   torch.as_tensor(acc_sum / M, dtype=dt, device=dev)])
            stem_stats, stack_stats = _bn_buffers(stem), _bn_buffers(stacks)
            sync_stats = train and update
            if mesh.size > 1:
                # stem: a sum over the pipe group (stage 0's alone), then a
                # mean over the data group = a sum over every rank / data
                world = [t.grad for t in stem_params] + [metrics]
                if sync_stats:
                    if not first:
                        for t in stem_stats:
                            t.zero_()
                    world += stem_stats
                all_reduce_(world, None, mesh.world)
            if mesh.world > 1:
                local = [t.grad for t in stack_params] + (stack_stats if sync_stats else [])
                all_reduce_(local, mesh.group, mesh.world)
            out = {'loss': metrics[0], 'acc': metrics[1],
                   'handoff_s': link.seconds if link is not None else 0.0}
        if not update:
            out['g_stem'] = {n: t.grad.clone() for n, t in stem.named_parameters()}
            out['g_stack'] = [{n: t.grad.clone() for n, t in s.named_parameters()}
                              for s in stacks]
            return state, out
        for opt in (state.opt_stem, state.opt_stack):
            for group in opt.param_groups:
                group['lr'] = state.tx.lr(state.step)
            opt.step()
        state.step += 1
        return state, out

    return step


def make_pipeline_train_step_raw(spec, mesh, *, num_microbatches: int, subset=None,
                                 pck_thr: float = 0.5):
    """The Trainer's pipelined step over RAW canvas batches: (state,
    raw_batch, rng) -> (state, metrics), as `make_train_step`'s
    device-pipeline step, the port of JAX `make_pipeline_train_step_raw`:
    every stage of data rank d augments d's rows of the global batch's
    draws (`train_state._global_draws`, the step's generator) and renders
    their targets (every stage's loss needs them), then steps them."""
    subset_t = tuple(subset) if subset is not None else None
    step = make_pipeline_train_step(mesh, num_microbatches=num_microbatches, train=True,
                                    update=True, pck_thr=pck_thr)

    def train_step(state: PipelineState, batch, rng):
        data = to_device(batch, next(state.stem.parameters()).device)
        data = augment_batch(data, _global_draws(spec, rng, state.step, data['scale'], mesh),
                             spec, True)
        target, tw = _select_subset(data['target'], data['target_weight'], subset_t)
        return step(state, data['image'], target, tw)

    return train_step
