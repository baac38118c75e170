"""Trainer: config-driven training loop with checkpoints and TB logs.

Port of `hourglass_pose_estimation_tpu/runner/trainer.py`:
RMSprop with the step decay, per-epoch train and validation with loss and
PCK, TensorBoard scalars (Loss|Accuracy x train|val, when tensorboardX
imports), a snapshot every `COMMON.snapshot` epochs and `best` on improved
validation PCK, resume from a checkpoint with the learning-rate schedule
fast-forwarded, and the frozen-BN phase from `TRAIN.freeze_bn_after_epoch`
(running-average BatchNorm, so the fused bottleneck runs in its forward and
its autograd Function in its backward). Validation runs the fused
bottleneck under `MODEL.fuse_block` too.

Two input pipelines, as `DATASET.device_pipeline` picks: the device one
(the host packs uint8 canvases, `canvas_batch`; the draws, the warp and the
render run in the step) and the host one (`host_batch`: the reference's
draws from a `np.random.RandomState` seeded (COMMON.seed * 1000003 + epoch)
mod 2^31 for each train epoch and 0 for validation, and cv2's warp; the
uint8 crops are normalised and their targets rendered on the card by
`prepare_host_batch`, on the step's stream, before the step).

Host and card overlap: a producer thread (`data.Prefetcher`) packs each
batch (reading and decoding image files there too), pins it and copies it
to the card on a side CUDA stream; the step's stream waits for that copy
(an event recorded after it) and the batch's tensors are marked as used on
the step's stream (`record_stream`), so the allocator does not hand their
memory to the next copy while the step still reads it. Step metrics stay on the card until
the epoch ends: one host fetch per epoch.

The JAX package's documented deviations hold here too: `TRAIN.epochs`
epochs (not epochs + 1).

Data parallelism over the ranks of a process group (`torchrun`; see
`parallel/`): `TRAIN.data_parallel` (0 = every rank) must match the world
size; each rank loads its contiguous rows of every global batch
(`Loader(shard=(rank, world))`, so TRAIN.train_batch and val_batch divide
by the world size) and steps them: through DDP with global-batch
BatchNorm (the default, implicit path), or through the explicit step
(`TRAIN.explicit_collectives`, with `TRAIN.sync_bn` choosing global or
per-replica BatchNorm statistics; it needs the device pipeline, and the
frozen-BN phase runs on the implicit path only, as in JAX). The train
metrics are the global batch's; validation all-reduces its sums and counts
once a pass, the padded rows of the last batch masked out. Rank 0 logs
(img/s counts every data rank's rows) and writes the checkpoints; every
rank restores them. With TRAIN.bn_stat_samples the implicit path's
statistics are the global batch's first rows, the explicit path's each
rank's (`norm.sync_batch_norm`'s `global_rows`).

Pipeline parallelism over stacks (`TRAIN.pipeline_parallel` = P > 1, the
port of the JAX Trainer's pipeline mode, `parallel/pipeline.py`): the
ranks form a (data x pipe) layout (rank = d * P + p), each stage trains
the stem and its stacks of the hg model the config builds (its own
modules, `pipeline.stage_of`: the standard path's initial weights from
COMMON.seed), and each step is the GPipe step of
`TRAIN.microbatches` microbatches over the data rank's rows
(`make_pipeline_train_step_raw`). It needs the device pipeline and refuses
the explicit step, tensor parallelism, remat, a stack count P does not
divide, a train batch data_parallel * microbatches does not divide, the
frozen-BN phase and any architecture but hg, as JAX does (JAX fails on
another architecture inside `split_hourglass_variables`). Validation runs
the merged model (the stages' stacks gathered) through the standard eval
step, its rows divided over every rank and its sums all-reduced over all
of them. Checkpoints are merged, in the standard layout, with the
optimizer state as {'stem', 'stack'} (`runner/checkpoint.py`); a pipeline
resume splits them again, and either layout resumes the other with a
fresh optimizer.

Tensor parallelism over conv output channels (`TRAIN.model_parallel` = T >
1, the JAX Trainer's 'model' mesh axis; `parallel/tensor_parallel.py`):
the ranks form a (data x model) layout (rank = d * T + m), the model is
built from COMMON.seed as without it and then sharded by the JAX rule
(`shard_model`: this rank's slice of every conv with 128 or more output
channels and of its BatchNorm), its RMSprop accumulators made from the
shards, DDP and the BatchNorm statistics over the data group; every model
rank of a data coordinate steps the same rows. The frozen-BN phase takes
the standard blocks (a sharded block does not fuse). Validation gathers
the parameters and statistics into a standard-layout replica once a pass
and runs the standard eval step on it (the fused bottleneck and the decode
as without tensor parallelism), its rows over every rank; checkpoints are
the standard layout, the accumulators gathered too, and a resume shards
them again, so a run with or without tensor parallelism resumes the
other's. The explicit step refuses it (the config), as does the pipeline.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch.config import Config
from hourglass_pose_estimation_torch.data import (
    Loader, Prefetcher, get_dataset, make_spec, prepare_host_batch, resolve_num_classes,
    to_device)
from hourglass_pose_estimation_torch.models import model_from_config
from hourglass_pose_estimation_torch.models.norm import sync_batch_norm
from hourglass_pose_estimation_torch.parallel.mesh import local_mesh, make_mesh
from hourglass_pose_estimation_torch.runner import checkpoint as ckpt_lib
from hourglass_pose_estimation_torch.runner.train_state import (
    TrainState, init_state, make_eval_step, make_optimizer, make_train_step)
from hourglass_pose_estimation_torch.utils.evaluation import combine_pck_counts
from hourglass_pose_estimation_torch.utils.summary import count_params, summarize


def refuse_pipeline(cfg: Config, world: int) -> None:
    """Raise ValueError for what pipeline parallelism does not take (the
    JAX Trainer's refusals and messages, and its architecture); `world` is
    the number of ranks."""
    tc, pp = cfg.train, cfg.train.pipeline_parallel
    if not cfg.dataset.device_pipeline:
        raise ValueError('pipeline_parallel requires DATASET.device_pipeline=True')
    if tc.explicit_collectives or tc.model_parallel > 1:
        raise ValueError('pipeline_parallel is incompatible with '
                         'explicit_collectives/model_parallel')
    if cfg.model.arch != 'hg':
        raise ValueError(f'pipeline_parallel splits the stacks of MODEL.arch=hg; '
                         f'{cfg.model.arch!r} has no hourglass stacks to split')
    if cfg.model.num_stacks % pp:
        raise ValueError(f'num_stacks {cfg.model.num_stacks} not divisible by '
                         f'pipeline_parallel {pp}')
    if tc.remat:
        raise ValueError('TRAIN.remat is not supported under pipeline_parallel (stages '
                         'are already the recompute granularity)')
    if tc.freeze_bn_after_epoch:
        raise ValueError('TRAIN.freeze_bn_after_epoch is only supported on the standard '
                         '(non-pipeline, implicit-collectives) path')
    dp = tc.data_parallel or max(world // pp, 1)
    if tc.train_batch % (dp * tc.microbatches):
        raise ValueError(f'TRAIN.train_batch {tc.train_batch} must divide by '
                         f'data_parallel*microbatches = {dp * tc.microbatches}')


def refuse_explicit(cfg: Config) -> None:
    """Raise ValueError for what the explicit step does not take."""
    tc = cfg.train
    if tc.explicit_collectives and not cfg.dataset.device_pipeline:
        raise ValueError('TRAIN.explicit_collectives requires DATASET.device_pipeline=True')
    if tc.explicit_collectives and tc.freeze_bn_after_epoch:
        raise ValueError('TRAIN.freeze_bn_after_epoch is only supported on the '
                         'implicit-collectives path')


class Trainer:
    """Builds model, optimizer and datasets from a Config and trains on
    `device` (the card unless device='cpu' is asked for; a CUDA device
    without an index is the rank's current one)."""

    def __init__(self, cfg: Config, num_classes: Optional[int] = None,
                 verbose: bool = True, device='cuda', eval_only: bool = False):
        """eval_only=True skips the train split (its annotations need not
        exist on a machine that only evaluates): the val dataset stands in
        for the pipeline spec and the never-iterated train loader, and
        `train()` refuses to run; it is the shell of one process's state
        (no process group's layout, no pipeline) even under torchrun."""
        mc, dc, tc = cfg.model, cfg.dataset, cfg.train
        self.pp = 1 if eval_only else tc.pipeline_parallel
        if self.pp > 1:
            refuse_pipeline(cfg, dist.get_world_size() if dist.is_initialized() else 1)
        refuse_explicit(cfg)
        self.mesh = (local_mesh(device) if eval_only else
                     make_mesh(tc.data_parallel, tc.model_parallel, device, self.pp))
        self.device = self.mesh.device
        self.cfg = cfg
        self.verbose = verbose
        self.eval_only = eval_only

        self.num_classes = num_classes or resolve_num_classes(cfg)
        dtype = torch.bfloat16 if tc.precision == 'bf16' else torch.float32
        # weights from COMMON.seed, without touching the global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.common.seed)
            self.model = model_from_config(
                mc, num_classes=self.num_classes, out_res=dc.out_res,
                device=self.device, dtype=dtype, remat=tc.remat,
                bn_stat_samples=tc.bn_stat_samples)
        # global-batch statistics on the implicit path for any architecture
        # (JAX's jit over a sharded batch computes them, its sampled ones
        # from the global batch's first rows), and on the explicit one under
        # TRAIN.sync_bn (JAX's bn_axis_name='data', each shard's rows), over
        # the data group; the pipeline's are per microbatch, unsynced (JAX
        # builds its stem and stack with no bn_axis_name)
        if (self.pp == 1 and self.mesh.group is not None
                and (not tc.explicit_collectives or tc.sync_bn)):
            sync_batch_norm(self.model, global_rows=not tc.explicit_collectives,
                            group=self.mesh.group)

        ds_kwargs = dict(image_path=dc.image_path,
                         annotation_path=dc.annotation_path,
                         inp_res=dc.inp_res, out_res=dc.out_res,
                         sigma=dc.sigma, scale_factor=dc.scale_factor,
                         rot_factor=dc.rot_factor, num_samples=dc.num_samples)
        self.val_ds = get_dataset(dc.name, False, **ds_kwargs)
        self.train_ds = (self.val_ds if eval_only
                         else get_dataset(dc.name, True, **ds_kwargs))
        self.spec = make_spec(self.train_ds)
        # train rows by data rank (every stage of it steps them); validation
        # rows over every rank
        self.train_loader = Loader(self.train_ds, tc.train_batch, shuffle=True,
                                   seed=cfg.common.seed, drop_last=True,
                                   shard=(self.mesh.rank, self.mesh.world))
        self.val_loader = Loader(self.val_ds, tc.val_batch, shuffle=False,
                                 seed=cfg.common.seed, drop_last=False,
                                 shard=(self.mesh.process_rank, self.mesh.size))

        steps_per_epoch = tc.steps_per_epoch or len(self.train_loader)
        self.steps_per_epoch = min(steps_per_epoch, len(self.train_loader))
        self.tx = make_optimizer(tc.learning_rate, tc.schedule, tc.gamma,
                                 self.steps_per_epoch)
        # the standard model's numbers, before any sharding
        self._log(f"==> model '{mc.arch}', stacks={mc.num_stacks}, "
                  f'params={count_params(self.model):,}, device={self.device}, '
                  f'mesh={self.mesh.shape}')
        if cfg.common.summary:
            self._log(summarize(self.model))
        if self.mesh.model > 1:
            from hourglass_pose_estimation_torch.parallel.tensor_parallel import (
                ShardedTrainState)
            # the model as built from the seed, sharded in place (a standard
            # replica kept for validation and checkpoints)
            self.state = ShardedTrainState.create(self.model, self.tx, self.mesh)
        elif self.pp > 1:
            from hourglass_pose_estimation_torch.parallel.pipeline import (
                PipelineState, stage_of)
            # the stage holds the model's own stem and stacks: the standard
            # path's initial weights, trained in place
            self.state = PipelineState.create(*stage_of(self.model, self.mesh), self.tx,
                                              self.mesh, mc.num_stacks)
        else:
            self.state = init_state(self.model, self.tx)
        self.start_epoch = 0
        self.best_acc = 0.0
        self.history = []        # one dict of numbers per epoch run

        self.canvas = dc.canvas or max(dc.inp_res, 64)
        self.crop_aware = dc.canvas_mode == 'crop'
        self.device_pipeline = dc.device_pipeline
        if self.pp > 1:
            from hourglass_pose_estimation_torch.parallel.pipeline import (
                make_pipeline_train_step_raw)
            self.train_step = make_pipeline_train_step_raw(
                self.spec, self.mesh, num_microbatches=tc.microbatches, subset=mc.subset,
                pck_thr=cfg.common.pck)
        elif tc.explicit_collectives:
            from hourglass_pose_estimation_torch.parallel.shard_map_step import (
                make_shard_map_train_step)
            self.train_step = make_shard_map_train_step(
                self.spec, self.mesh, subset=mc.subset, pck_thr=cfg.common.pck,
                sync_bn=tc.sync_bn)
        else:
            self.train_step = make_train_step(
                self.spec, subset=mc.subset, pck_thr=cfg.common.pck,
                device_pipeline=self.device_pipeline, mesh=self.mesh)
        # late-training frozen BN: a second step whose forward uses the
        # running averages, built when first reached
        self.freeze_bn_after = tc.freeze_bn_after_epoch
        self._frozen_step = None
        self.eval_step = make_eval_step(
            self.spec, subset=mc.subset, pck_thr=cfg.common.pck,
            device_pipeline=self.device_pipeline)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == 'cuda' else None)

        self.ckpt_dir = os.path.join(cfg.common.checkpoint_dir, 'ckpts')
        self.writer = None
        if cfg.common.resume:
            if os.path.exists(cfg.common.resume):
                self._resume(cfg.common.resume)
            else:
                # COMMON.resume may name a checkpoint not written yet, so the
                # same config resumes after a crash; say so, for a typo
                self._log(f'=> no checkpoint found at '
                          f'{cfg.common.resume!r} — starting fresh')

    # ------------------------------------------------------------------
    def _resume(self, path: str):
        payload = ckpt_lib.restore(path, self.state)
        self.state = payload['state']
        self.start_epoch = payload['epoch']
        self.best_acc = payload['best_acc']
        self._log(f"=> resumed from '{path}' at epoch {self.start_epoch}")
        self._fast_forward_schedule()

    def _fast_forward_schedule(self):
        """The port's learning rate is indexed by `state.step`, so the
        schedule's position is the step. A checkpoint that carries epoch > 0
        but step 0 (an import with no optimizer history) would restart at
        the undecayed rate: restore step == epoch * steps_per_epoch. Trainer
        snapshots already satisfy it."""
        if self.state.step == 0 and self.start_epoch > 0:
            self.state.step = self.start_epoch * self.steps_per_epoch
            self._log('=> checkpoint carried no optimizer history: '
                      f'fast-forwarded the LR schedule to step {self.state.step} '
                      f'(epoch {self.start_epoch})')

    def _log(self, msg):
        if self.verbose and self.mesh.process_rank == 0:
            print(msg, flush=True)

    def _stage(self, raw: dict):
        """Producer side: a host batch -> (tensors on the device, the event
        that marks their copy done, or None on the CPU)."""
        if self._copy_stream is None:
            return to_device(raw, self.device), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
            dev = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True) for k, v in raw.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _take(self, staged) -> dict:
        """Consumer side: the step's stream waits for the batch's copy, and
        the batch's memory stays reserved until that stream is done with
        it."""
        dev, ready = staged
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for t in dev.values():
                t.record_stream(compute)
        return dev

    def _prepare(self, batch: dict) -> dict:
        """A staged host-pipeline batch -> the step's inputs (normalised
        image, targets and weights, rendered on the current stream); a
        device-pipeline batch goes to the step as it is."""
        if self.device_pipeline:
            return batch
        return prepare_host_batch(batch, self.spec)

    def _make_produce(self, ds, train: bool, epoch: int = 0, with_valid: bool = False):
        """Host batch producer, shared by _train_epoch and _evaluate: the
        canvases of the device pipeline, or the host pipeline's crops drawn
        from the JAX Trainer's RandomState seeds (validation draws
        nothing)."""
        if not self.device_pipeline:
            seed = (self.cfg.common.seed * 1000003 + epoch) % (2 ** 31) if train else 0
            host_rng = np.random.RandomState(seed)

        def produce(item):
            idx, valid = item
            if self.device_pipeline:
                raw = ds.canvas_batch(idx, canvas=self.canvas, crop_aware=self.crop_aware)
            else:
                crops = ds.host_batch(idx, host_rng, train=train)
                raw = {k: crops[k] for k in ('image', 'joints', 'vis')}
            if with_valid:
                raw['valid'] = valid
            return self._stage(raw)
        return produce

    # ------------------------------------------------------------------
    def _train_epoch(self, epoch: int, rng: int):
        """One epoch of train steps -> (loss, PCK, images per second)."""
        step_fn = self.train_step
        if self.freeze_bn_after and epoch >= self.freeze_bn_after:
            if self._frozen_step is None:
                self._frozen_step = make_train_step(
                    self.spec, subset=self.cfg.model.subset,
                    pck_thr=self.cfg.common.pck, device_pipeline=self.device_pipeline,
                    freeze_bn=True, mesh=self.mesh)
                self._log(f'=> BatchNorm frozen (running averages) from '
                          f'epoch {epoch + 1} on')
            step_fn = self._frozen_step
        batches = self.train_loader.epoch_indices()[:self.steps_per_epoch]
        t0 = time.time()
        n_img = 0
        step_metrics = []
        total = len(batches)
        prefetch = Prefetcher(batches, self._make_produce(self.train_ds, True, epoch))
        try:
            for i, (staged, (idx, _valid)) in enumerate(prefetch, 1):
                batch = self._prepare(self._take(staged))
                self.state, metrics = step_fn(self.state, batch, rng)
                step_metrics.append(torch.stack([metrics['loss'], metrics['acc']]))
                n_img += len(idx)
                if total >= 50 and i % 50 == 0:
                    el = time.time() - t0
                    self._log(f'    [{i}/{total}] elapsed {el:.0f}s '
                              f'eta {el / i * (total - i):.0f}s (dispatch)')
        finally:
            # abandoning the iteration (a step raised) must stop the producer
            prefetch.close()
        if not step_metrics:
            return 0.0, 0.0, 0.0
        vals = torch.stack(step_metrics).cpu().numpy()      # ONE fetch
        dt = time.time() - t0
        loss, acc = float(vals[:, 0].mean()), float(vals[:, 1].mean())
        n_img *= self.mesh.world            # every rank stepped its rows
        self._log(f'  train: loss {loss:.5f} | pck {acc:.4f} | '
                  f'{n_img / dt:.1f} img/s')
        return loss, acc, n_img / dt

    def _eval_state(self) -> TrainState:
        """The state validation runs: under pipeline parallelism the merged
        model, in the standard eval step. The stem and this stage's stacks
        are the model's own modules; the other stages' stacks are gathered
        into it (a collective of every pipe group). Under tensor parallelism
        the standard replica with the gathered parameters and statistics (a
        collective of every model group)."""
        if self.mesh.model > 1:
            return TrainState(model=self.state.standard_model(), tx=self.tx, optimizer=None,
                              step=self.state.step)
        if self.pp == 1:
            return self.state
        self.model.load_state_dict(self.state.hourglass_state())
        return TrainState(model=self.model, tx=self.tx, optimizer=None, step=self.state.step)

    def _evaluate(self):
        """Validation over the whole split -> (loss, PCK), each batch
        weighted by its valid samples (padded ones masked out). A batch's
        loss and PCK are the global batch's: its loss sums, sample counts
        and per-joint hit and valid counts are summed over the ranks (one
        all-reduce a pass)."""
        state = self._eval_state()
        prefetch = Prefetcher(self.val_loader.epoch_indices(),
                              self._make_produce(self.val_ds, False, with_valid=True))
        rows = []
        try:
            for staged, _ in prefetch:
                batch = self._take(staged)
                valid = batch.pop('valid')
                m = self.eval_step(state, self._prepare(batch), valid)
                rows.append(torch.cat([torch.stack([m['loss_sum'], m['n'].double()]),
                                       m['hit'].double(), m['joints'].double()]))
        finally:
            prefetch.close()
        if not rows:
            return 0.0, 0.0
        sums = torch.stack(rows)
        if self.mesh.group is not None:
            dist.all_reduce(sums)                   # every rank's rows
        sums = sums.cpu()                                   # ONE fetch
        # each global batch's loss and PCK in f32, weighted by its valid
        # samples: in one process, the eval step's own f32 numbers
        n = sums[:, 1].float().numpy()
        loss = (sums[:, 0] / sums[:, 1].clamp_min(1.0)).float().numpy()
        J = (sums.shape[1] - 2) // 2
        acc = np.array([combine_pck_counts(s[2:2 + J].float(), s[2 + J:].float())[0]
                        for s in sums], np.float32)
        tot = max(n.sum(), 1.0)
        return float((loss * n).sum() / tot), float((acc * n).sum() / tot)

    # ------------------------------------------------------------------
    def _open_writer(self):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(logdir=os.path.join(
            self.cfg.common.checkpoint_dir, 'logs', 'train'))

    def train(self) -> float:
        """Run epochs start_epoch .. TRAIN.epochs - 1 -> best val PCK."""
        if self.eval_only:
            raise RuntimeError('Trainer was built with eval_only=True '
                               '(no train split loaded)')
        cfg = self.cfg
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if self.writer is None and self.mesh.process_rank == 0:
            self.writer = self._open_writer()
        # one augmentation seed per epoch, split off a stream from seed + 1;
        # the train step folds the step in (train_state.step_generator)
        rng = np.random.SeedSequence(cfg.common.seed + 1)
        for epoch in range(self.start_epoch, cfg.train.epochs):
            self._log(f'Epoch {epoch + 1}/{cfg.train.epochs}')
            t0 = time.time()
            rng, sub = rng.spawn(2)
            loss, acc, rate = self._train_epoch(epoch, int(sub.generate_state(1)[0]))
            val_loss, val_acc = self._evaluate()
            self._log(f'  val:   loss {val_loss:.5f} | pck {val_acc:.4f}')
            self.history.append(dict(
                epoch=epoch + 1, train_loss=loss, train_acc=acc,
                images_per_s=rate, val_loss=val_loss, val_acc=val_acc,
                seconds=time.time() - t0))

            if self.writer:
                self.writer.add_scalar('Loss/train', loss, epoch)
                self.writer.add_scalar('Accuracy/train', acc, epoch)
                self.writer.add_scalar('Loss/val', val_loss, epoch)
                self.writer.add_scalar('Accuracy/val', val_acc, epoch)

            is_best = val_acc > self.best_acc
            if is_best:
                self.best_acc = val_acc
            if (epoch + 1) % cfg.common.snapshot == 0:
                ckpt_lib.save(os.path.join(self.ckpt_dir, f'checkpoint_{epoch + 1}'),
                              self.state, epoch + 1, self.best_acc)
            if is_best:
                ckpt_lib.save(os.path.join(self.ckpt_dir, 'best'),
                              self.state, epoch + 1, self.best_acc)
        if self.writer:
            self.writer.close()
        return self.best_acc
