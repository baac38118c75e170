"""The port's decoders, `utils/inference.py`, OKS and PCKh against the JAX
package's, on the CPU, on the same seeded numpy inputs: f32 heatmaps with
planted ties, peaks on the edges, all-negative and all-zero maps.

Tolerances: the argmax, the quarter step and the simple decode take the
same f32 values in the same order, so heatmap-space peaks and offsets are
equal (checked through an identity affine), and image-space coordinates
within 1e-4 px (the inverse affine's f32 rounding). The blurs sum the same
taps in another order: 1e-6. DARK divides by a finite-difference Hessian
of the log of that blur, which amplifies the blur's last bits: 1e-3 px,
and the same joints stepped. The NMS map on maps without plateaus: 1e-6.
The NMS peaks (coordinates and the order of tied peaks): equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hourglass_pose_estimation_tpu.data import oks as joks
from hourglass_pose_estimation_tpu.data.mpii import evaluate_pckh as jax_pckh
from hourglass_pose_estimation_tpu.ops import decode as jdecode
from hourglass_pose_estimation_tpu.utils import evaluation as jeval
from hourglass_pose_estimation_tpu.utils import inference as jinf

from hourglass_pose_estimation_torch.data import oks as toks
from hourglass_pose_estimation_torch.data.mpii import (
    MPII_JOINT_NAMES, evaluate_pckh, save_pred_mat)
from hourglass_pose_estimation_torch.ops import decode as tdecode
from hourglass_pose_estimation_torch.utils import evaluation as teval
from hourglass_pose_estimation_torch.utils import inference as tinf

torch.set_num_threads(1)

B, H, W, J = 6, 16, 20, 5


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream (the conftest one is shared by every
    file a test worker runs)."""
    return np.random.RandomState(0)


@pytest.fixture(scope='module')
def maps(rng):
    """[6, 16, 20, 5] f32: Gaussian peaks over noise, and in sample 0 a
    planted tie (two equal maxima, the later one in row-major order
    first in the array's other axis), peaks on each edge and a corner,
    an all-negative map and an all-zero map."""
    ys, xs = np.mgrid[0:H, 0:W]
    hm = np.zeros((B, H, W, J), np.float32)
    for b in range(B):
        for j in range(J):
            cx, cy = rng.uniform(1, W - 2), rng.uniform(1, H - 2)
            hm[b, :, :, j] = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 4.0)
    hm += rng.uniform(0, 0.05, size=hm.shape).astype(np.float32)
    hm[0, :, :, 0] = 0.1
    hm[0, 9, 3, 0] = hm[0, 4, 15, 0] = 2.0         # tie: (15, 4) first
    hm[0, 6, 6, 0] = 1.5
    hm[0, :, :, 1] *= 0.1
    hm[0, 0, 7, 1] = 3.0                          # top edge
    hm[0, :, :, 2] *= 0.1
    hm[0, H - 1, W - 1, 2] = 3.0                  # corner
    hm[0, :, :, 3] = -rng.uniform(0.5, 2.0, size=(H, W))   # all negative
    hm[0, :, :, 4] = 0.0                          # all zero
    hm[1, :, :, 0] *= 0.1
    hm[1, 8, 0, 0] = 3.0                          # left edge
    hm[1, :, :, 1] *= 0.1
    hm[1, 1, W - 2, 1] = 3.0                      # one in from the edges
    return hm


@pytest.fixture(scope='module')
def boxes(rng):
    return (rng.uniform(100, 200, size=(B, 2)).astype(np.float32),
            rng.uniform(0.8, 2.0, size=(B, 2)).astype(np.float32))


def _identity():
    """Boxes whose inverse affine is the identity on the heatmap."""
    return (np.tile(np.float32([W / 2, H / 2]), (B, 1)),
            np.tile(np.float32([W / 200.0, W / 200.0]), (B, 1)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_get_preds_matches_jax_on_ties_and_negative_maps(maps):
    got, gm = teval.get_preds(_t(maps))
    ref, rm = jeval.get_preds(jnp.asarray(maps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    assert got[0, 3].tolist() == [0.0, 0.0] and got[0, 4].tolist() == [0.0, 0.0]
    assert got[0, 0].tolist() == [15.0, 5.0]      # the first of the tie, (15, 4): (x̂, ŷ+1)


@pytest.mark.parametrize('zero_based', [False, True])
def test_quarter_offset_matches_jax(maps, boxes, zero_based):
    hm = _t(maps)
    got, gm = tdecode.decode_quarter_offset(hm, *_identity(), zero_based=zero_based)
    ref, rm = jdecode.decode_quarter_offset(jnp.asarray(maps), *_identity(),
                                            zero_based=zero_based)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    got, _ = tdecode.decode_quarter_offset(hm, *boxes, zero_based=zero_based)
    ref, _ = jdecode.decode_quarter_offset(jnp.asarray(maps), *boxes, zero_based=zero_based)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    # affine_size: the frame the inverse affine maps from
    got, _ = tdecode.decode_quarter_offset(hm, *boxes, zero_based=zero_based,
                                           affine_size=(64, 48))
    ref, _ = jdecode.decode_quarter_offset(jnp.asarray(maps), *boxes,
                                           zero_based=zero_based, affine_size=(64, 48))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_simple_argmax_matches_jax(maps):
    maps = maps.copy()
    maps[2, :, :, 0] = 0.001                      # below the threshold -> (0, 0)
    got, gm = tdecode.decode_simple_argmax(_t(maps), (80, 64), (512, 384))
    ref, rm = jdecode.decode_simple_argmax(jnp.asarray(maps), (80, 64), (512, 384))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    assert got[2, 0].tolist() == [0, 0]


def test_gaussian_blur_matches_jax(maps):
    got = tdecode.gaussian_blur(_t(maps), 11).numpy()
    ref = np.asarray(jdecode.gaussian_blur(jnp.asarray(maps), 11))
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(got))
    # the all-negative map is rescaled by 1e20: compare it relatively
    np.testing.assert_allclose(got[..., :3], ref[..., :3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('zero_based', [False, True])
def test_dark_matches_jax(maps, boxes, zero_based):
    hm = _t(maps)
    base = (tdecode.get_preds_zero_based(hm)[0] if zero_based
            else teval.get_preds(hm)[0]).numpy()
    got, gm = tdecode.decode_dark(hm, *_identity(), zero_based=zero_based)
    ref, rm = jdecode.decode_dark(jnp.asarray(maps), *_identity(), zero_based=zero_based)
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    stepped = (got != base).any(-1)
    assert np.array_equal(stepped, (ref != base).any(-1))
    assert stepped.sum() > B * J // 2 and not stepped[0, 4]     # the all-zero map
    got, _ = tdecode.decode_dark(hm, *boxes, zero_based=zero_based)
    ref, _ = jdecode.decode_dark(jnp.asarray(maps), *boxes, zero_based=zero_based)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_nms_heatmap_matches_jax(rng):
    hm = rng.rand(2, 24, 20, 5).astype(np.float32)
    for b in range(2):
        for j in range(5):
            hm[b, rng.randint(24), rng.randint(20), j] += 3.0
    hm[0, 0, 0, 0] += 4.0                         # a peak on the corner
    got = tdecode.nms_heatmap(_t(hm)).numpy()
    ref = np.asarray(jdecode.nms_heatmap(jnp.asarray(hm)))
    assert np.array_equal(got > 0, ref > 0) and (got > 0).sum() > 20
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _twin_peaks():
    """Equal peaks on a zero map, so the blurred maxima tie exactly; the
    later in row-major order is planted first."""
    hm = np.zeros((2, 24, 20, 3), np.float32)
    hm[:, 15, 4, :] = hm[:, 6, 12, :] = 2.0
    hm[0, 10, 10, 1] = 3.0
    hm[1, 20, 2, 2] = 1.0
    hm[1, :, :, 0] = 0.0                          # all zero -> (0, 0, 0)
    return hm


def test_nms_peaks_and_topk_match_jax_on_ties(rng):
    hm = _twin_peaks()
    got = tdecode.decode_nms_peaks(_t(hm)).numpy()
    ref = np.asarray(jdecode.decode_nms_peaks(jnp.asarray(hm)))
    np.testing.assert_array_equal(got[..., :2], ref[..., :2])
    np.testing.assert_allclose(got[..., 2], ref[..., 2], rtol=0, atol=1e-6)
    assert got[0, 0, :2].tolist() == [12.0, 6.0] and got[1, 0].tolist() == [0, 0, 0]
    gxy, gc = tdecode.decode_nms_topk(_t(hm), k=4)
    rxy, rc = jdecode.decode_nms_topk(jnp.asarray(hm), k=4)
    np.testing.assert_array_equal(gxy.numpy(), np.asarray(rxy))
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=0, atol=1e-6)
    assert gxy[0, 0, :2].tolist() == [[12.0, 6.0], [4.0, 15.0]]
    # random maps: every slot, the zero-conf tail included
    hm = rng.rand(2, 24, 20, 3).astype(np.float32)
    gxy, gc = tdecode.decode_nms_topk(_t(hm), k=6)
    rxy, rc = jdecode.decode_nms_topk(jnp.asarray(hm), k=6)
    np.testing.assert_array_equal(gxy.numpy(), np.asarray(rxy))
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=0, atol=1e-6)


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_inference_wrappers_match_jax(maps, boxes, layout):
    hms = maps.transpose(0, 3, 1, 2) if layout == 'NCHW' else maps
    for center, scale in ((boxes[0], boxes[1]), (boxes[0][0], np.float32(1.3)),
                          (boxes[0][0], boxes[1][0])):
        got = tinf.get_final_preds_v1(hms, center, scale, layout=layout)
        ref = jinf.get_final_preds_v1(hms, center, scale, layout=layout)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        got = tinf.get_final_preds_v2(hms, center, scale, output_size=(64, 48), layout=layout)
        ref = jinf.get_final_preds_v2(hms, center, scale, output_size=(64, 48), layout=layout)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    got = tinf.gaussian_blur(hms[:, :3] if layout == 'NCHW' else hms[..., :3], layout=layout)
    ref = jinf.gaussian_blur(hms[:, :3] if layout == 'NCHW' else hms[..., :3], layout=layout)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match='layout'):
        tinf.get_final_preds_v1(hms, boxes[0], boxes[1], layout='HWC')
    with pytest.raises(ValueError, match='ambiguous'):
        tinf.get_final_preds_v1(hms[:2], boxes[0][0], np.float32([1.0, 2.0]), layout=layout)


def test_oks_matches_jax(rng, tmp_path):
    N, Jc = 7, 17
    gts = rng.uniform(0, 300, size=(N, Jc, 2))
    preds = gts + rng.normal(0, 8, size=gts.shape)
    vis = (rng.uniform(size=(N, Jc)) > 0.2).astype(np.float32)
    vis[3] = 0.0                                  # an instance with nothing labelled
    scales = rng.uniform(0.5, 2.0, size=(N, 2))
    for expand in (1.0, 1.25):
        ta = toks.instance_areas_from_scales(scales, scale_expand=expand)
        ja = joks.instance_areas_from_scales(scales, scale_expand=expand)
        np.testing.assert_allclose(ta, ja, rtol=1e-6)
    areas = toks.instance_areas_from_scales(scales[:, 0])
    np.testing.assert_allclose(areas, joks.instance_areas_from_scales(scales[:, 0]), rtol=1e-6)
    got = toks.compute_oks(preds, gts, vis, areas)
    ref = joks.compute_oks(preds, gts, vis, areas)
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    assert np.isnan(got[3])
    got_t = toks.oks_recall(preds, gts, vis, areas)
    ref_t = joks.oks_recall(preds, gts, vis, areas)
    assert got_t.keys() == ref_t.keys()
    for k in ref_t:
        assert abs(got_t[k] - ref_t[k]) <= 1e-6, k
    crowd = toks.oks_recall(preds[:, :14], gts[:, :14], vis[:, :14], areas, toks.CROWDPOSE_SIGMAS)
    assert crowd == joks.oks_recall(preds[:, :14], gts[:, :14], vis[:, :14], areas,
                                    joks.CROWDPOSE_SIGMAS)
    assert toks.oks_recall(preds, gts, np.zeros_like(vis), areas)['AR'] == 0.0
    with pytest.raises(ValueError, match='sigmas'):
        toks.compute_oks(preds[:, :5], gts[:, :5], vis[:, :5], areas)
    scores = rng.uniform(size=N)
    ids = np.arange(N) + 100
    a = toks.write_coco_results(preds, scores, ids, str(tmp_path / 'a' / 'r.json'))
    b = joks.write_coco_results(preds, scores, ids, str(tmp_path / 'b' / 'r.json'))
    assert open(a).read() == open(b).read()
    assert toks.coco_eval_ap(a, a) == joks.coco_eval_ap(b, b)


def test_pckh_and_pred_mat_match_jax(rng, tmp_path):
    """The fabricated gt .mat of the JAX package's test_pckh_evaluator:
    perfect, off-by-more-than-0.5-headsize and noisy predictions, with
    missing joints; the tables equal, and the same pred.mat."""
    from scipy.io import loadmat, savemat
    N = 4
    gt = rng.uniform(50, 200, size=(16, 2, N))
    headboxes = np.zeros((2, 2, N))
    headboxes[0], headboxes[1] = 100.0, 160.0
    missing = np.zeros((16, N))
    missing[3, 1] = missing[12, 2] = 1.0
    path = str(tmp_path / 'gt_valid.mat')
    savemat(path, {'dataset_joints': np.array([MPII_JOINT_NAMES], dtype=object),
                   'jnt_missing': missing, 'pos_gt_src': gt, 'headboxes_src': headboxes})
    perfect = gt.transpose(2, 0, 1) - 1.0
    headsize = np.linalg.norm([60, 60]) * 0.6
    for preds in (perfect, perfect + headsize * 0.6,
                  perfect + rng.normal(0, headsize * 0.4, size=perfect.shape)):
        table, mean = evaluate_pckh(preds, path, output_dir=str(tmp_path / 'port'))
        ref, ref_mean = jax_pckh(preds, path, output_dir=str(tmp_path / 'jax'))
        assert list(table) == list(ref) and mean == ref_mean
        for k in ref:
            assert float(table[k]) == float(ref[k]), k
        np.testing.assert_array_equal(loadmat(tmp_path / 'port' / 'pred.mat')['preds'],
                                      loadmat(tmp_path / 'jax' / 'pred.mat')['preds'])
    assert evaluate_pckh(perfect, path)[1] == 100.0
    assert evaluate_pckh(perfect, path, image_set='test') == ({'Null': 0.0}, 0.0)
    out = save_pred_mat(perfect, str(tmp_path / 'only'))
    np.testing.assert_array_equal(loadmat(out)['preds'], perfect + 1.0)
