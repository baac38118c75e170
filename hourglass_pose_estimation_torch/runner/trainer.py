"""Trainer: config-driven training loop with checkpoints and TB logs.

Port of `hourglass_pose_estimation_tpu/runner/trainer.py` for one card:
RMSprop with the step decay, per-epoch train and validation with loss and
PCK, TensorBoard scalars (Loss|Accuracy x train|val, when tensorboardX
imports), a snapshot every `COMMON.snapshot` epochs and `best` on improved
validation PCK, resume from a checkpoint with the learning-rate schedule
fast-forwarded, and the frozen-BN phase from `TRAIN.freeze_bn_after_epoch`
(running-average BatchNorm, so the fused bottleneck runs in its forward and
its autograd Function in its backward). Validation runs the fused
bottleneck under `MODEL.fuse_block` too.

Host and card overlap: a producer thread (`data.Prefetcher`) packs each
batch's canvases, pins them and copies them to the card on a side CUDA
stream; the step's stream waits for that copy (an event recorded after
it) and the batch's tensors are marked as used on the step's stream
(`record_stream`), so the allocator does not hand their memory to the next
copy while the step still reads it. Step metrics stay on the card until
the epoch ends: one host fetch per epoch.

The JAX package's documented deviations hold here too: `TRAIN.epochs`
epochs (not epochs + 1). Several devices (data, tensor or pipeline
parallelism, explicit collectives) and the host cv2 pipeline are refused
with the ROADMAP item that brings them.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.config import Config
from hourglass_pose_estimation_torch.data import (
    Loader, Prefetcher, get_dataset, make_spec, resolve_num_classes, to_device)
from hourglass_pose_estimation_torch.models import model_from_config
from hourglass_pose_estimation_torch.runner import checkpoint as ckpt_lib
from hourglass_pose_estimation_torch.runner.train_state import (
    init_state, make_eval_step, make_optimizer, make_train_step)
from hourglass_pose_estimation_torch.utils.summary import count_params, summarize


def refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError for what this single-card trainer lacks."""
    tc = cfg.train
    multi = [f'TRAIN.{k}={v}' for k, v, on in (
        ('pipeline_parallel', tc.pipeline_parallel, tc.pipeline_parallel > 1),
        ('explicit_collectives', tc.explicit_collectives, tc.explicit_collectives),
        ('model_parallel', tc.model_parallel, tc.model_parallel > 1),
        ('data_parallel', tc.data_parallel, tc.data_parallel > 1)) if on]
    if multi:
        raise NotImplementedError(
            f"{', '.join(multi)}: training on several devices is not ported yet "
            '(ROADMAP Queue 1 item 13); the port trains on one card')
    if not cfg.dataset.device_pipeline:
        raise NotImplementedError(
            'DATASET.device_pipeline=False (the host cv2 pipeline) is not ported '
            'yet (ROADMAP Queue 1 item 9)')


class Trainer:
    """Builds model, optimizer and datasets from a Config and trains on
    `device` (the card unless device='cpu' is asked for)."""

    def __init__(self, cfg: Config, num_classes: Optional[int] = None,
                 verbose: bool = True, device='cuda', eval_only: bool = False):
        """eval_only=True skips the train split (its annotations need not
        exist on a machine that only evaluates): the val dataset stands in
        for the pipeline spec and the never-iterated train loader, and
        `train()` refuses to run."""
        self.device = resolve_device(device)
        refuse_unported(cfg)
        self.cfg = cfg
        self.verbose = verbose
        self.eval_only = eval_only
        mc, dc, tc = cfg.model, cfg.dataset, cfg.train

        self.num_classes = num_classes or resolve_num_classes(cfg)
        dtype = torch.bfloat16 if tc.precision == 'bf16' else torch.float32
        # weights from COMMON.seed, without touching the global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.common.seed)
            self.model = model_from_config(
                mc, num_classes=self.num_classes, out_res=dc.out_res,
                device=self.device, dtype=dtype, remat=tc.remat,
                bn_stat_samples=tc.bn_stat_samples)

        ds_kwargs = dict(image_path=dc.image_path,
                         annotation_path=dc.annotation_path,
                         inp_res=dc.inp_res, out_res=dc.out_res,
                         sigma=dc.sigma, scale_factor=dc.scale_factor,
                         rot_factor=dc.rot_factor, num_samples=dc.num_samples)
        self.val_ds = get_dataset(dc.name, False, **ds_kwargs)
        self.train_ds = (self.val_ds if eval_only
                         else get_dataset(dc.name, True, **ds_kwargs))
        self.spec = make_spec(self.train_ds)
        self.train_loader = Loader(self.train_ds, tc.train_batch, shuffle=True,
                                   seed=cfg.common.seed, drop_last=True)
        self.val_loader = Loader(self.val_ds, tc.val_batch, shuffle=False,
                                 seed=cfg.common.seed, drop_last=False)

        steps_per_epoch = tc.steps_per_epoch or len(self.train_loader)
        self.steps_per_epoch = min(steps_per_epoch, len(self.train_loader))
        self.tx = make_optimizer(tc.learning_rate, tc.schedule, tc.gamma,
                                 self.steps_per_epoch)
        self.state = init_state(self.model, self.tx)
        self._log(f"==> model '{mc.arch}', stacks={mc.num_stacks}, "
                  f'params={count_params(self.model):,}, device={self.device}')
        if cfg.common.summary:
            self._log(summarize(self.model))
        self.start_epoch = 0
        self.best_acc = 0.0
        self.history = []        # one dict of numbers per epoch run

        self.canvas = dc.canvas or max(dc.inp_res, 64)
        self.crop_aware = dc.canvas_mode == 'crop'
        self.train_step = make_train_step(
            self.spec, subset=mc.subset, pck_thr=cfg.common.pck,
            device_pipeline=True)
        # late-training frozen BN: a second step whose forward uses the
        # running averages, built when first reached
        self.freeze_bn_after = tc.freeze_bn_after_epoch
        self._frozen_step = None
        self.eval_step = make_eval_step(
            self.spec, subset=mc.subset, pck_thr=cfg.common.pck,
            device_pipeline=True)
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
        if self.verbose:
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

    def _make_produce(self, ds, with_valid: bool = False):
        """Host batch producer, shared by _train_epoch and _evaluate."""
        def produce(item):
            idx, valid = item
            raw = ds.canvas_batch(idx, canvas=self.canvas, crop_aware=self.crop_aware)
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
                    pck_thr=self.cfg.common.pck, device_pipeline=True,
                    freeze_bn=True)
                self._log(f'=> BatchNorm frozen (running averages) from '
                          f'epoch {epoch + 1} on')
            step_fn = self._frozen_step
        batches = self.train_loader.epoch_indices()[:self.steps_per_epoch]
        t0 = time.time()
        n_img = 0
        step_metrics = []
        total = len(batches)
        prefetch = Prefetcher(batches, self._make_produce(self.train_ds))
        try:
            for i, (staged, (idx, _valid)) in enumerate(prefetch, 1):
                self.state, metrics = step_fn(self.state, self._take(staged), rng)
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
        self._log(f'  train: loss {loss:.5f} | pck {acc:.4f} | '
                  f'{n_img / dt:.1f} img/s')
        return loss, acc, n_img / dt

    def _evaluate(self):
        """Validation over the whole split -> (loss, PCK), each batch
        weighted by its valid samples (padded ones masked out)."""
        prefetch = Prefetcher(self.val_loader.epoch_indices(),
                              self._make_produce(self.val_ds, with_valid=True))
        rows = []
        try:
            for staged, _ in prefetch:
                batch = self._take(staged)
                valid = batch.pop('valid')
                m = self.eval_step(self.state, batch, valid)
                rows.append(torch.stack([m['loss'], m['acc'], m['n']]))
        finally:
            prefetch.close()
        if not rows:
            return 0.0, 0.0
        vals = torch.stack(rows).cpu().numpy()              # ONE fetch
        n = vals[:, 2]
        tot = max(n.sum(), 1.0)
        return (float((vals[:, 0] * n).sum() / tot),
                float((vals[:, 1] * n).sum() / tot))

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
        if self.writer is None:
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
