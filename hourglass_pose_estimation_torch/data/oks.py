"""COCO-style OKS for top-down keypoints, numpy only (the port's own copy
of `hourglass_pose_estimation_tpu/data/oks.py`).

Protocol: ground-truth-box top-down evaluation. Each prediction is
scored against its own annotation instance (crops come from gt boxes, so
no matching step), with

    OKS = sum_i exp(-d_i^2 / (2 s^2 k_i^2)) * 1[v_i > 0] / sum_i 1[v_i > 0]

where s^2 is the instance area and k_i the COCO per-keypoint constants.
The headline number is mean OKS-RECALL over thresholds 0.50:0.05:0.95
(reported as AR/AR50/AR75: it is not score-ranked AP). The OKS formula
matches pycocotools. For the official score-ranked AP,
`write_coco_results` emits a pycocotools-format results JSON and
`coco_eval_ap` runs COCOeval when pycocotools is installed (it returns
None otherwise).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

COCO_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72,
                        .62, .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0

CROWDPOSE_SIGMAS = np.array([.79, .79, .72, .72, .62, .62, 1.07, 1.07,
                             .87, .87, .89, .89, .79, .79]) / 10.0


def compute_oks(preds: np.ndarray, gts: np.ndarray, vis: np.ndarray,
                areas: np.ndarray, sigmas: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """Per-instance OKS.

    Args:
      preds: [N, J, 2] predicted keypoints (image coords).
      gts:   [N, J, 2] ground-truth keypoints.
      vis:   [N, J] visibility (>0 counts as labeled).
      areas: [N] instance areas (pixels^2).
      sigmas: [J] per-keypoint constants (default COCO 17-kpt).

    Returns [N] OKS values (NaN where an instance has no labeled kpts).
    """
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    vis = np.asarray(vis)
    areas = np.asarray(areas, np.float64)
    if sigmas is None:
        sigmas = COCO_SIGMAS
    sigmas = np.asarray(sigmas, np.float64)
    if preds.shape[1] != sigmas.shape[0]:
        raise ValueError(f'{preds.shape[1]} joints but {sigmas.shape[0]} sigmas')

    d2 = np.sum((preds - gts) ** 2, axis=-1)                    # [N, J]
    # pycocotools: e = d^2 / (2 * vars * (area + eps)), vars = (2*sigma)^2
    var = (2.0 * sigmas) ** 2
    e = d2 / (var[None, :] * 2.0 * (areas[:, None] + np.spacing(1)))
    ks = np.exp(-e)
    labeled = vis > 0
    n_lab = labeled.sum(axis=1)
    oks = np.where(n_lab > 0,
                   (ks * labeled).sum(axis=1) / np.maximum(n_lab, 1),
                   np.nan)
    return oks


def oks_recall(preds, gts, vis, areas, sigmas=None) -> Dict[str, float]:
    """Mean OKS-recall over thresholds .50:.05:.95 (AR / AR50 / AR75).

    This is average RECALL on gt-matched pairs (every gt instance has
    exactly one prediction, by construction of the gt-box top-down
    protocol) — it is NOT pycocotools' score-ranked AP; the keys say
    so. For the real AP, export a results file with
    `write_coco_results` and run `coco_eval_ap` (needs pycocotools).
    """
    oks = compute_oks(preds, gts, vis, areas, sigmas)
    oks = oks[~np.isnan(oks)]
    if oks.size == 0:
        return {'AR': 0.0, 'AR50': 0.0, 'AR75': 0.0, 'mean_oks': 0.0}
    thrs = np.arange(0.50, 0.951, 0.05)
    recalls = [(oks >= t).mean() for t in thrs]
    return {
        'AR': float(np.mean(recalls)),
        'AR50': float((oks >= 0.50).mean()),
        'AR75': float((oks >= 0.75).mean()),
        'mean_oks': float(oks.mean()),
    }


def write_coco_results(preds: np.ndarray, scores: np.ndarray,
                       image_ids: np.ndarray, path: str,
                       kpt_scores: Optional[np.ndarray] = None,
                       category_id: int = 1) -> str:
    """Write a pycocotools-format keypoint results JSON.

    One entry per instance: {image_id, category_id, keypoints
    [x1,y1,s1,...], score}. This is the submission artifact the
    reference never produces (its COCO eval is heatmap PCK only); with
    it, the official scorer runs directly:
    `COCOeval(cocoGt, cocoGt.loadRes(path), 'keypoints')`.

    Args:
      preds: [N, J, 2] keypoints in source-image pixels.
      scores: [N] instance scores (e.g. mean heatmap peak value).
      image_ids: [N] COCO image ids.
      kpt_scores: optional [N, J] per-keypoint confidences (defaults to
        the instance score broadcast).
    """
    import json
    preds = np.asarray(preds, np.float64)
    scores = np.asarray(scores, np.float64)
    image_ids = np.asarray(image_ids)
    N, J = preds.shape[:2]
    if kpt_scores is None:
        kpt_scores = np.broadcast_to(scores[:, None], (N, J))
    results = []
    for i in range(N):
        kps = np.concatenate(
            [preds[i], np.asarray(kpt_scores[i], np.float64)[:, None]],
            axis=1).reshape(-1)
        results.append({
            'image_id': int(image_ids[i]),
            'category_id': int(category_id),
            'keypoints': [round(float(v), 3) for v in kps],
            'score': round(float(scores[i]), 4),
        })
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as fp:
        json.dump(results, fp)
    return path


def coco_eval_ap(ann_file: str, results_file: str,
                 sigmas=None) -> Optional[Dict[str, float]]:
    """Official COCOeval keypoint AP, when pycocotools is installed.

    Returns None when pycocotools is not installed —
    callers fall back to `oks_recall`, which is honestly labeled AR.

    `sigmas`: per-keypoint OKS constants. COCOeval's default is the
    17-element COCO array; any other joint count (e.g. crowdpose's 14)
    MUST pass its own or computeOks broadcasts a shape mismatch.
    """
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        return None
    gt = COCO(ann_file)
    dt = gt.loadRes(results_file)
    ev = COCOeval(gt, dt, 'keypoints')
    if sigmas is not None:
        ev.params.kpt_oks_sigmas = np.asarray(sigmas, np.float64)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    names = ['AP', 'AP50', 'AP75', 'APm', 'APl',
             'AR', 'AR50', 'AR75', 'ARm', 'ARl']
    return {n: float(v) for n, v in zip(names, ev.stats)}


def instance_areas_from_scales(scales: np.ndarray,
                               pixel_std: float = 200.0,
                               scale_expand: float = 1.25) -> np.ndarray:
    """Approximate instance area from the (expanded) crop scale: the
    dataset stored scale = 1.25 * box/200, so box area =
    (s*200/1.25)_w * (s*200/1.25)_h."""
    scales = np.asarray(scales, np.float64)
    if scales.ndim == 1:
        scales = np.stack([scales, scales], -1)
    side = scales * pixel_std / scale_expand
    return side[:, 0] * side[:, 1]
