"""Standalone evaluator (the `COMMON.evaluate_only` path).

Port of `hourglass_pose_estimation_tpu/runner/evaluator.py`: the val
loader (the ragged tail padded and masked), loss and heatmap PCK through
the eval step, the flip test, keypoints decoded to source-image pixels
(`EVAL.decode`, 0-based) and the dataset-official metrics (MPII PCKh,
OKS recall). On the card each forward runs the fused bottleneck,
upsample+add and pool kernels, the eval step the render kernel and the
quarter decode the decode kernel. Numbers stay on the device until one
host fetch at the end of a pass.

`DATASET.device_pipeline` picks the input pipeline, as in the Trainer:
canvases cropped on the device, or the host pipeline's cv2 crops
(`host_batch` with `RandomState(0)`, which validation draws nothing from),
normalised on the device, with the targets rendered by `prepare_host_batch`
for the loss and the center and scale taken from the batch for the decode.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.config import Config
from hourglass_pose_estimation_torch.data import (
    Loader, crop_batch, get_dataset, make_spec, normalize, prepare_host_batch,
    sample_augmentations, to_device)
from hourglass_pose_estimation_torch.data.mpii import evaluate_pckh, save_pred_mat
from hourglass_pose_estimation_torch.data.oks import (
    COCO_SIGMAS, CROWDPOSE_SIGMAS, coco_eval_ap, instance_areas_from_scales, oks_recall,
    write_coco_results)
from hourglass_pose_estimation_torch.ops.decode import decode_dark, decode_quarter_offset
from hourglass_pose_estimation_torch.runner.train_state import TrainState, make_eval_step


def flip_heatmaps(hms: torch.Tensor, flip_perm) -> torch.Tensor:
    """Heatmaps of a horizontally flipped input, made ready to average with
    the unflipped ones: W mirrored back, left/right joints swapped, and the
    classic one-pixel shift right so the peaks line up. [B, H, W, J]."""
    perm = torch.as_tensor(flip_perm, dtype=torch.int64, device=hms.device)
    out = torch.flip(hms, dims=[2])[..., perm]
    return torch.cat([out[:, :, :1], out[:, :, :-1]], dim=2)


class Evaluator:
    """Val-split metrics of a TrainState, on `device` (the card unless
    device='cpu' is asked for)."""

    def __init__(self, cfg: Config, verbose: bool = True, device='cuda'):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.verbose = verbose
        dc = cfg.dataset
        self.ds = get_dataset(dc.name, False, image_path=dc.image_path,
                              annotation_path=dc.annotation_path,
                              inp_res=dc.inp_res, out_res=dc.out_res,
                              sigma=dc.sigma, scale_factor=dc.scale_factor,
                              rot_factor=dc.rot_factor, num_samples=dc.num_samples)
        self.spec = make_spec(self.ds)
        self.loader = Loader(self.ds, cfg.train.val_batch, shuffle=False,
                             seed=cfg.common.seed, drop_last=False)
        self.canvas = dc.canvas or max(dc.inp_res, 64)
        self.crop_aware = dc.canvas_mode == 'crop'
        self.device_pipeline = dc.device_pipeline
        self.eval_step = make_eval_step(self.spec, subset=cfg.model.subset,
                                        pck_thr=cfg.common.pck,
                                        device_pipeline=self.device_pipeline)
        base = decode_dark if cfg.eval.decode == 'dark' else decode_quarter_offset
        # dataset-official metrics use the corrected 0-based decode (the
        # reference's 1-based space is kept only for its heatmap PCK)
        self._decode = functools.partial(base, zero_based=True)

    def _batch(self, idx) -> dict:
        """One val batch on the device: canvases, or the host crops with
        their geometry."""
        if self.device_pipeline:
            raw = self.ds.canvas_batch(idx, canvas=self.canvas, crop_aware=self.crop_aware)
        else:
            crops = self.ds.host_batch(idx, np.random.RandomState(0), train=False)
            raw = {k: crops[k] for k in ('image', 'joints', 'vis', 'center', 'scale')}
        return to_device(raw, self.device)

    def _stage(self, idx) -> dict:
        """One val batch as the eval step takes it (the host pipeline's
        targets rendered here)."""
        data = self._batch(idx)
        return data if self.device_pipeline else prepare_host_batch(data, self.spec)

    def evaluate(self, state: TrainState) -> Tuple[float, float]:
        """Averaged (val loss, heatmap PCK), the reference's metric: each
        batch weighted by its valid samples; one host fetch at the end."""
        rows = []
        for idx, valid in self.loader.epoch_indices():
            m = self.eval_step(state, self._stage(idx), valid)
            rows.append(torch.stack([m['loss'], m['acc'], m['n']]))
        vals = torch.stack(rows).cpu().numpy()
        n = vals[:, 2]
        tot = max(n.sum(), 1.0)
        loss = float((vals[:, 0] * n).sum() / tot)
        acc = float((vals[:, 1] * n).sum() / tot)
        if self.verbose:
            print(f'val: loss {loss:.5f} | pck {acc:.4f}', flush=True)
        return loss, acc

    def flip_permutation(self, flip_test: bool) -> Tuple[int, ...]:
        """The joint permutation under a flip, in the model's channels: with
        MODEL.subset re-indexed into subset space, which needs the subset
        to be closed under the left/right pairs (else ValueError when
        flip_test, the identity otherwise)."""
        perm = self.spec.flip_perm
        if not self.cfg.model.subset:
            return perm
        sub = list(self.cfg.model.subset)
        try:
            return tuple(sub.index(perm[j]) for j in sub)
        except ValueError:
            if flip_test:
                raise ValueError('EVAL.flip_test requires MODEL.subset to be closed '
                                 f'under the flip pairs; got {sub} with flip_perm {perm}')
            return tuple(range(len(sub)))

    @torch.no_grad()
    def batch_heatmaps(self, state: TrainState, idx, flip_test: bool, perm):
        """One val batch -> (last-stack heatmaps [B, H, W, J] f32, flip-test
        averaged when asked, and the crops' centers [B, 2] and scales
        [B, 2]), on the device."""
        data = self._batch(idx)
        if self.device_pipeline:
            draws = sample_augmentations(None, data['scale'], scale_factor=self.spec.scale_factor,
                                         rot_factor=self.spec.rot_factor, train=False)
            data = crop_batch(data, draws, self.spec, False)
            image = data['image']
        else:
            image = normalize(data['image'], self.spec)
        hms = state.model(image, train=False)[-1]
        if flip_test:
            hf = state.model(torch.flip(image, dims=[2]), train=False)[-1]
            hms = 0.5 * (hms + flip_heatmaps(hf, perm))
        return hms, data['center'], data['scale']

    def predict_keypoints(self, state: TrainState, flip_test: Optional[bool] = None,
                          return_scores: bool = False):
        """Keypoints of the whole val set in source-image pixels (for
        dataset-official metrics) -> [N, J, 2] f32 numpy; with
        return_scores also [N, J] heatmap peak values. Under MODEL.subset
        the model's channels are scattered into the dataset's full joint
        set; the other joints stay 0 (and score as misses)."""
        flip_test = self.cfg.eval.flip_test if flip_test is None else flip_test
        perm = self.flip_permutation(flip_test)
        N, J = len(self.ds), self.ds.n_joints
        subset = self.cfg.model.subset
        cols = np.asarray(subset, np.int64) if subset else np.arange(J)
        batches = self.loader.epoch_indices()
        got = [self._decode(*self.batch_heatmaps(state, idx, flip_test, perm))
               for idx, _ in batches]
        preds = torch.cat([p for p, _ in got]).cpu().numpy()       # ONE fetch
        maxv = torch.cat([m for _, m in got]).cpu().numpy()
        idx = np.concatenate([i for i, _ in batches])
        sel = np.concatenate([v for _, v in batches]) > 0
        all_preds = np.zeros((N, J, 2), np.float32)
        all_scores = np.zeros((N, J), np.float32)
        all_preds[np.ix_(idx[sel], cols)] = preds[sel]
        all_scores[np.ix_(idx[sel], cols)] = maxv[sel]
        if return_scores:
            return all_preds, all_scores
        return all_preds

    def evaluate_official(self, state: TrainState, output_dir: Optional[str] = None) -> dict:
        """Dataset-official metrics and submission artifacts:

          * MPII with EVAL.gt_mat: the PCKh@0.5 table, saving `pred.mat`
            (a test split short-circuits after saving it);
          * otherwise (and MPII without a gt .mat, after saving
            `pred.mat`): the OKS recall against the loader's own
            instances, and for a dataset with COCO image ids a
            pycocotools-format results file, scored by COCOeval when
            pycocotools is installed.

        Returns a dict of named values."""
        if output_dir is None:
            output_dir = self.cfg.common.checkpoint_dir
        preds, scores = self.predict_keypoints(state, return_scores=True)
        name = self.cfg.dataset.name
        if name == 'mpii':
            if self.cfg.eval.gt_mat:
                table, _ = evaluate_pckh(preds, self.cfg.eval.gt_mat,
                                         output_dir=output_dir or '',
                                         image_set=getattr(self.ds, 'image_set', 'valid'))
                return dict(table)
            if output_dir:
                save_pred_mat(preds, output_dir)
        r = self.ds.records
        if name == 'crowdpose':
            sigmas = CROWDPOSE_SIGMAS
        elif self.ds.n_joints == 17:
            sigmas = COCO_SIGMAS
        else:
            # a uniform kappa where a dataset has no published constants
            sigmas = np.full((self.ds.n_joints,), 0.079)
        # datasets store scale = expand * box / 200 (mpii and coco bake in
        # 1.25, synthetic stores the covering box): divide out this one's
        areas = instance_areas_from_scales(
            r.scales, scale_expand=getattr(self.ds, 'scale_stored_expand', 1.25))
        table = oks_recall(preds, r.joints, r.vis, areas, sigmas)
        image_ids = getattr(self.ds, 'image_ids', None)
        if image_ids is not None and output_dir:
            path = write_coco_results(
                preds, scores.mean(axis=1), image_ids,
                os.path.join(output_dir, f'keypoints_{name}_results.json'),
                kpt_scores=scores)
            table['results_file'] = path
            official = coco_eval_ap(self.ds._ann_file(), path, sigmas=sigmas)
            if official is not None:
                table.update({f'coco_{k}': v for k, v in official.items()})
        return table
