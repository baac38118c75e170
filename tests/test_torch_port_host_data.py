"""The port's host data layer against the JAX package's, on the CPU: the
host transforms, the MPII, COCO, CrowdPose and Hands readers, the data
selection and statistics, the cv2 host pipeline, the canvases from JPEG
files (the native loader and cv2, both packing modes, the whole-image
resize), the native build, the host pipeline's device tail, the Trainer on
an MPII tree under both pipelines, and the official evaluation on MPII and
COCO trees.

Trees are seeded and fabricated (`data.fabricate`) in the readers' on-disk
formats: 160x120 JPEGs. Tolerances: the transforms, records, selections,
host crops and canvases equal bit for bit (the same numpy, cv2 and native
code on the same files); compute_meanstd within 1e-12; prepare_host_batch
within 1e-6 (the render's f32 exp); the Trainers with the f32 limits of
`test_torch_port_trainer.py` (at 128^2, where those limits were read);
the official tables equal and the keypoints within the evaluator tests'
limits (98% within 1e-3 px, all within a heatmap pixel: random weights
give flat maps); DARK's keypoints (the COCO config's decode) all within
1e-2 px: its Newton step divides by the map's curvature, which on those
flat maps turns the packages' f32 noise into up to 4e-3 px (read here).
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hourglass_pose_estimation_tpu import config as jconfig
from hourglass_pose_estimation_tpu.data import get_dataset as jax_get_dataset
from hourglass_pose_estimation_tpu.data import make_spec as jax_make_spec
from hourglass_pose_estimation_tpu.data import native as jax_native
from hourglass_pose_estimation_tpu.data.pipeline import (
    prepare_host_batch as jax_prepare_host_batch)
from hourglass_pose_estimation_tpu.runner.evaluator import Evaluator as JaxEvaluator
from hourglass_pose_estimation_tpu.utils import transforms as jt

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch.data import (
    fabricate, get_dataset, make_spec, native, prepare_host_batch)
from hourglass_pose_estimation_torch.runner import Evaluator
from hourglass_pose_estimation_torch.utils import transforms as tt

from test_torch_port_evaluator import _close_keypoints, _jax_state, _port_state
from test_torch_port_trainer import _trainer_matches_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIZE = (160, 120)
KW = dict(inp_res=64, out_res=16, sigma=1, scale_factor=0.25, rot_factor=30)
TOL_DARK_PX = 1e-2
RECORD_FIELDS = ('centers', 'scales', 'joints', 'vis', 'widths', 'image_paths')


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream (the conftest one is shared by every
    file a test worker runs)."""
    return np.random.RandomState(0)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """One seeded tree per reader; in the MPII tree the first valid person's
    image is a PNG (the native loader reads JPEGs only)."""
    import cv2
    root = tmp_path_factory.mktemp('trees')
    img, ann, gt = fabricate.mpii_tree(str(root / 'mpii'), np.random.RandomState(1), n_train=8,
                                       n_valid=6, image_size=SIZE, scales=(0.3, 0.55),
                                       n_small=2, small_scale=0.2)
    valid = json.loads((Path(ann) / 'valid.json').read_text())
    png = valid[0]['image'].replace('.jpg', '.png')
    cv2.imwrite(str(Path(img) / png), cv2.imread(str(Path(img) / valid[0]['image'])))
    valid[0]['image'] = png
    (Path(ann) / 'valid.json').write_text(json.dumps(valid))
    out = {'mpii': dict(image_path=img, annotation_path=ann, gt_mat=gt)}
    for i, name in enumerate(('mscoco', 'crowdpose', 'hands')):
        img, ann = fabricate.coco_tree(str(root / name), np.random.RandomState(2 + i),
                                       dataset=name, n_persons=6, image_size=SIZE)
        out[name] = dict(image_path=img, annotation_path=ann)
    return out


def _pair(trees, name, train, **kw):
    paths = {k: v for k, v in trees[name].items() if k != 'gt_mat'}
    kw = {**KW, **paths, **kw}
    return get_dataset(name, train, **kw), jax_get_dataset(name, train, **kw)


def _equal_dicts(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# --- transforms

def test_host_transforms_equal_jax(rng):
    for _ in range(20):
        c = rng.uniform(0, 500, 2)
        s = rng.uniform(0.3, 3.0, 2) if rng.rand() < 0.5 else rng.uniform(0.3, 3.0)
        rot, size = rng.uniform(-60, 60), tuple(rng.randint(16, 300, 2))
        shift = rng.uniform(-0.2, 0.2, 2)
        for inv in (False, True):
            np.testing.assert_array_equal(tt.get_affine_transform(c, s, rot, size, shift, inv),
                                          jt.get_affine_transform(c, s, rot, size, shift, inv))
        trans = jt.get_affine_transform(c, s, rot, size)
        pt = rng.uniform(0, 400, 2)
        np.testing.assert_array_equal(tt.affine_transform(pt, trans), jt.affine_transform(pt, trans))
        coords = rng.uniform(0, 64, (5, 16, 2))
        np.testing.assert_array_equal(tt.transform_preds(coords, c, s, (64, 64)),
                                      jt.transform_preds(coords, c, s, (64, 64)))
        joints, vis = rng.uniform(0, 300, (16, 3)), (rng.rand(16, 3) > 0.3).astype(np.float64)
        pairs = [[0, 5], [1, 4], [2, 3], [10, 15]]
        for a, b in zip(tt.fliplr_joints(joints, vis, 320, pairs),
                        jt.fliplr_joints(joints, vis, 320, pairs)):
            np.testing.assert_array_equal(a, b)


# --- readers, selection, statistics

@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('name', ['mpii', 'mscoco', 'crowdpose', 'hands'])
def test_readers_records_equal_jax(trees, name, train):
    ours, ref = _pair(trees, name, train)
    n = 6 + 2 * train if name == 'mpii' else 6               # persons the tree holds
    assert len(ours) == len(ref) == n and ours.n_joints == ref.n_joints
    for f in RECORD_FIELDS:
        a, b = getattr(ours.records, f), getattr(ref.records, f)
        assert type(a) is type(b), f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.records.images is ref.records.images is None
    if name == 'mpii':
        assert (ours.records.widths == -1).all()             # deferred to the images
    else:
        # the crowd, zero-area and all-zero-keypoint annotations skipped
        np.testing.assert_array_equal(ours.image_ids, ref.image_ids)
        assert ours.image_ids.dtype == np.int64 and ours._ann_file() == ref._ann_file()
    assert ours.flip_pairs == ref.flip_pairs and ours.image_set == ref.image_set


@pytest.mark.parametrize('name', ['mpii', 'synthetic'])
def test_selection_and_meanstd_equal_jax(trees, name):
    if name == 'synthetic':
        ours = get_dataset('synthetic', True, num_samples=12, **KW)
        ref = jax_get_dataset('synthetic', True, num_samples=12, **KW)
    else:
        ours, ref = _pair(trees, 'mpii', True)
    keep = ours.select_data()
    np.testing.assert_array_equal(keep, ref.select_data())
    assert keep.dtype == np.int64
    idxs = np.array([5, 0, 3, 3])
    ours.apply_selection(idxs)
    ref.apply_selection(idxs)
    for f in RECORD_FIELDS + ('images',):
        np.testing.assert_array_equal(getattr(ours.records, f), getattr(ref.records, f), err_msg=f)
    for a, b in zip(ours.compute_meanstd(), ref.compute_meanstd()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


# --- the host pipeline

@pytest.mark.parametrize('name,train', [('mpii', True), ('mpii', False), ('synthetic', True)])
def test_host_batch_equal_jax(trees, name, train):
    """The same RandomState seed: the same draws, flips (about the image's
    own width: MPII defers it), cv2 crops and joints. The port's crop is
    the uint8 cv2 gave, the JAX package's the same values in f32."""
    if name == 'synthetic':
        ours = get_dataset('synthetic', True, num_samples=6, **KW)
        ref = jax_get_dataset('synthetic', True, num_samples=6, **KW)
    else:
        ours, ref = _pair(trees, name, True)
    idx = [0, 3, 1, 5, 2, 4] * 2
    got = ours.host_batch(idx, np.random.RandomState(7), train=train)
    want = ref.host_batch(idx, np.random.RandomState(7), train=train)
    assert got['image'].dtype == np.uint8 and want['image'].dtype == np.float32
    got['image'] = got['image'].astype(np.float32)
    _equal_dicts(got, want)
    if train:
        assert len(set(got['rotation'].tolist())) > 2          # draws were taken


# --- canvases

def _native_dir_hashes():
    """sha256 of every file under native/ but the JAX package's own build
    of the library (which its loader may write there at any time)."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / 'native').iterdir())
            if p.is_file() and not p.name.startswith('libhostloader.so')}


@pytest.mark.parametrize('use_native', [True, False])
@pytest.mark.parametrize('crop_aware', [True, False])
def test_canvas_batch_equal_jax(trees, monkeypatch, crop_aware, use_native):
    """Canvases of JPEG files (and one PNG) equal the JAX package's bit for
    bit, the native loader on (both packages' builds of one source) and
    forced off (cv2 for every slot); the whole image at q = 64/160."""
    if use_native:
        assert native.available() and jax_native.available(), native.unavailable_reason()
    else:
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, 'load_canvas_batch', lambda *a, **k: None)
            monkeypatch.setattr(mod, 'load_region_batch', lambda *a, **k: None)
    idx = [0, 1, 4, 2, 5, 0]
    for train in (True, False):
        ours, ref = _pair(trees, 'mpii', train)
        got = ours.canvas_batch(idx, canvas=64, crop_aware=crop_aware)
        _equal_dicts(got, ref.canvas_batch(idx, canvas=64, crop_aware=crop_aware))
        assert (got['width'] == SIZE[0]).all() and (got['canvas'] > 0).any()
        png = 0 if train else 2            # the PNG slots: none in train, 2 in valid
        n_native = (len(idx) - png) if use_native else 0
        assert ours.slot_paths == {'native': n_native, 'cv2': len(idx) - n_native, 'memory': 0}
    if not crop_aware:
        np.testing.assert_allclose(got['canvas_scale'], 64 / 160)
        np.testing.assert_allclose(got['canvas_offset'], (1 - 0.4) / 0.8)


def test_native_builds_from_the_source_and_leaves_native_untouched(tmp_path):
    before = _native_dir_hashes()
    assert set(before) >= {'hostloader.cpp', 'Makefile'}
    assert native.build(str(tmp_path)) is None
    assert Path(native.library_path(str(tmp_path))).is_file()
    assert native.available() and native.unavailable_reason() is None
    lib = Path(native.get_lib()._name).resolve()
    assert lib == Path(native.library_path()).resolve()
    assert lib.parent == (REPO / 'hourglass_pose_estimation_torch' / 'data' / 'native_build')
    assert sorted(p.name for p in tmp_path.iterdir()) == ['libhostloader.so']
    assert _native_dir_hashes() == before


def test_canvas_batch_in_memory_needs_no_native_loader():
    """In-memory images: the numpy region warp (crop mode) and the
    whole-image copy (q = 1) count as memory slots; q != 1 takes cv2's
    resize, as the JAX package's, bit for bit."""
    ours = get_dataset('synthetic', False, num_samples=4, **KW)
    ref = jax_get_dataset('synthetic', False, num_samples=4, **KW)
    for canvas in (64, 48, 80):
        _equal_dicts(ours.canvas_batch([0, 1, 3], canvas=canvas),
                     ref.canvas_batch([0, 1, 3], canvas=canvas))
    ours.canvas_batch([0, 1], canvas=64, crop_aware=True)
    assert ours.slot_paths == {'native': 0, 'cv2': 0, 'memory': 11}


# --- the host pipeline's device tail

def test_prepare_host_batch_matches_jax(rng, trees):
    ours, ref = _pair(trees, 'mpii', True)
    crops = ours.host_batch(list(range(8)), np.random.RandomState(3))
    got = prepare_host_batch({k: torch.from_numpy(v) for k, v in crops.items()}, make_spec(ours))
    want = jax_prepare_host_batch({k: jnp.asarray(v, jnp.float32 if k == 'image' else None)
                                   for k, v in crops.items() if k in ('image', 'joints', 'vis')},
                                  jax_make_spec(ref))
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)
    assert got['target_weight'].sum() > 0


# --- the Trainer on an MPII tree, each pipeline, against the JAX Trainer

@pytest.mark.parametrize('device_pipeline', [True, False])
def test_trainer_on_mpii_files_matches_jax(trees, tmp_path, monkeypatch, device_pipeline):
    paths = {k: v for k, v in trees['mpii'].items() if k != 'gt_mat'}
    _trainer_matches_jax(
        tmp_path, monkeypatch, 'f32',
        DATASET={'name': 'mpii', 'device_pipeline': device_pipeline, **paths},
        MODEL={'fuse_block': False}, TRAIN={'freeze_bn_after_epoch': 0})


# --- the official evaluation on the readers

def _eval_raw(tree, name, **eval_kw):
    return {
        'DATASET': {'name': name, **KW, **{k: v for k, v in tree.items() if k != 'gt_mat'}},
        'MODEL': {'arch': 'hg', 'num_stacks': 1, 'num_blocks': 1},
        'TRAIN': {'val_batch': 4, 'precision': 'f32'},
        'COMMON': {'seed': 0},
        'EVAL': {'flip_test': True, **eval_kw},
    }


def test_evaluate_official_on_mpii_matches_jax(trees, tmp_path):
    """The PCKh table on the tree's gt_valid.mat and pred.mat."""
    from scipy.io import loadmat
    raw = _eval_raw(trees['mpii'], 'mpii', gt_mat=trees['mpii']['gt_mat'])
    jstate = _jax_state(16)
    got = Evaluator(tconfig.load_config(raw=raw), verbose=False, device='cpu').evaluate_official(
        _port_state(jstate, 16), output_dir=str(tmp_path / 'port'))
    want = JaxEvaluator(jconfig.load_config(raw=raw), verbose=False).evaluate_official(
        jstate, output_dir=str(tmp_path / 'jax'))
    assert list(got) == list(want) == ['Head', 'Shoulder', 'Elbow', 'Wrist', 'Hip', 'Knee',
                                       'Ankle', 'Mean', 'Mean@0.1']
    assert got == want and np.isfinite(list(got.values())).all()
    a, b = (loadmat(str(tmp_path / d / 'pred.mat'))['preds'] for d in ('port', 'jax'))
    assert a.shape == b.shape == (6, 16, 2)
    _close_keypoints(a - 1.0, b - 1.0)


def test_evaluate_official_on_coco_matches_jax(trees, tmp_path):
    """The OKS table and the results file keyed by the reader's image ids
    (no pycocotools here: no COCOeval numbers)."""
    raw = _eval_raw(trees['mscoco'], 'mscoco', decode='dark')
    jstate = _jax_state(17)
    got = Evaluator(tconfig.load_config(raw=raw), verbose=False, device='cpu').evaluate_official(
        _port_state(jstate, 17), output_dir=str(tmp_path / 'port'))
    want = JaxEvaluator(jconfig.load_config(raw=raw), verbose=False).evaluate_official(
        jstate, output_dir=str(tmp_path / 'jax'))
    assert got.keys() == want.keys() == {'AR', 'AR50', 'AR75', 'mean_oks', 'results_file'}
    for k in ('AR', 'AR50', 'AR75', 'mean_oks'):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    rows, ref = (json.loads(Path(t['results_file']).read_text()) for t in (got, want))
    assert len(rows) == len(ref) == 6
    assert [(r['image_id'], r['category_id']) for r in rows] == \
        [(r['image_id'], r['category_id']) for r in ref]
    kp = lambda rs: np.array([r['keypoints'] for r in rs]).reshape(6, 17, 3)
    assert np.abs(kp(rows)[..., :2] - kp(ref)[..., :2]).max() <= TOL_DARK_PX
    np.testing.assert_allclose(kp(rows)[..., 2], kp(ref)[..., 2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([r['score'] for r in rows], [r['score'] for r in ref],
                               rtol=1e-4, atol=1e-5)
