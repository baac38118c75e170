"""The port's standalone evaluator, its CLI branch and the Estimator against
the JAX package's, on the CPU: f32, 1 stack, 64^2 -> 16^2, synthetic data,
the JAX weights carried over with `load_jax_variables`.

The val set (10 samples at batch 4) does not divide into batches: the last
batch is padded and masked. Tolerances: the loss within 1e-5 relative and
the PCK within one joint of N * J (f32 sums in another order); keypoints
of the whole forward at least 98% within 1e-3 px and every one within a
heatmap pixel's size in the image (4 px here): random weights give flat
maps with near-ties, where f32 noise may move an argmax; the decoder fed
the JAX package's own heatmaps exactly; the OKS table within 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu import config as jconfig
from hourglass_pose_estimation_tpu.data.pipeline import augment_batch as jax_augment
from hourglass_pose_estimation_tpu.export import make_inference_fn as jax_inference_fn
from hourglass_pose_estimation_tpu.models import HourglassNet as JaxNet
from hourglass_pose_estimation_tpu.ops import decode as jdecode
from hourglass_pose_estimation_tpu.runner.estimator import Estimator as JaxEstimator
from hourglass_pose_estimation_tpu.runner.evaluator import Evaluator as JaxEvaluator
from hourglass_pose_estimation_tpu.runner.evaluator import flip_heatmaps as jax_flip
from hourglass_pose_estimation_tpu.runner.train_state import (
    init_state as jax_init_state, make_optimizer as jax_optimizer)

from hourglass_pose_estimation_torch import config as tconfig
from hourglass_pose_estimation_torch import train_and_evaluate
from hourglass_pose_estimation_torch.data.meanstd import ESTIMATOR_MEANSTD
from hourglass_pose_estimation_torch.export import make_inference_fn
from hourglass_pose_estimation_torch.models import get_model
from hourglass_pose_estimation_torch.ops import decode as tdecode
from hourglass_pose_estimation_torch.runner import (
    Estimator, Evaluator, flip_heatmaps, init_state, make_optimizer)
from hourglass_pose_estimation_torch.runner import evaluator as evaluator_mod
from hourglass_pose_estimation_torch.weights import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / 'configs' / 'train_synthetic_tiny.yaml')
N, BATCH = 10, 4
PIXEL = 4.0          # one heatmap pixel in the image: a 64 px box on 16 px maps


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream (the conftest one is shared by every
    file a test worker runs)."""
    return np.random.RandomState(0)


def _raw(**over):
    raw = {
        'DATASET': {'name': 'synthetic', 'inp_res': 64, 'out_res': 16, 'sigma': 1,
                    'scale_factor': 0.25, 'rot_factor': 30, 'num_samples': N},
        'MODEL': {'arch': 'hg', 'num_stacks': 1, 'num_blocks': 1},
        'TRAIN': {'val_batch': BATCH, 'precision': 'f32'},
        'COMMON': {'seed': 0, 'in_res': 64, 'out_res': 16, 'dataset': 'synthetic'},
        'EVAL': {'flip_test': True},
    }
    for k, v in over.items():
        raw[k] = {**raw[k], **v}
    return raw


def _jax_state(classes: int):
    model = JaxNet(num_stacks=1, num_blocks=1, num_classes=classes, dtype=jnp.float32)
    return jax_init_state(model, jax.random.PRNGKey(classes), (1, 64, 64, 3),
                          jax_optimizer(1e-3, [], 0.1, 1))


def _port_state(jstate, classes: int):
    """The port's TrainState with `jstate`'s weights; its model takes its
    kernels' switches on (plain versions here)."""
    port = get_model('hg', device='cpu', num_stacks=1, num_classes=classes,
                     dtype=torch.float32, fuse_block=True, fuse_upsample=True)
    load_jax_variables(port, {'params': jax.tree.map(np.asarray, jstate.params),
                              'batch_stats': jax.tree.map(np.asarray, jstate.batch_stats)})
    return init_state(port, make_optimizer(1e-3, [], 0.1, 1))


@pytest.fixture(scope='module')
def jstate16():
    """One JAX state of random 16-joint weights for the whole file."""
    return _jax_state(16)


@pytest.fixture(scope='module')
def full(jstate16):
    return (JaxEvaluator(jconfig.load_config(raw=_raw()), verbose=False), jstate16,
            Evaluator(tconfig.load_config(raw=_raw()), verbose=False, device='cpu'),
            _port_state(jstate16, 16))


@pytest.fixture(scope='module')
def jax_predictions(full):
    """The JAX Evaluator's flip-test keypoints and scores (its jitted
    forward compiles on each call: one call serves the file)."""
    jev, jstate, _, _ = full
    return jev.predict_keypoints(jstate, return_scores=True)


def _close_keypoints(got, ref):
    d = np.abs(got - ref).max(-1)
    assert (d <= 1e-3).mean() >= 0.98, np.sort(d.ravel())[-10:]
    assert d.max() <= PIXEL, d.max()


def test_flip_heatmaps_matches_jax(rng):
    hm = rng.uniform(size=(2, 8, 10, 16)).astype(np.float32)
    perm = tuple(int(i) for i in rng.permutation(16))
    got = flip_heatmaps(torch.from_numpy(hm), perm).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_flip(jnp.asarray(hm), perm)))


def test_evaluate_matches_jax(full):
    jev, jstate, tev, tstate = full
    assert len(tev.loader) == 3 and tev.loader.epoch_indices()[-1][1].sum() == N - 2 * BATCH
    loss, acc = tev.evaluate(tstate)
    ref_loss, ref_acc = jev.evaluate(jstate)
    assert np.isfinite(loss) and abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert abs(acc - ref_acc) <= 1.0 / (N * 16)


def test_predict_keypoints_flip_test_matches_jax(full, jax_predictions):
    jev, jstate, tev, tstate = full
    got, gs = tev.predict_keypoints(tstate, return_scores=True)
    ref, rs = jax_predictions
    assert got.shape == (N, 16, 2) and gs.shape == (N, 16)
    _close_keypoints(got, np.asarray(ref))
    np.testing.assert_allclose(gs, rs, rtol=1e-4, atol=1e-5)
    plain = tev.predict_keypoints(tstate, flip_test=False)
    assert not np.allclose(plain, got)
    # the decoder on the JAX package's own flip-averaged heatmaps: exact
    idx = tev.loader.epoch_indices()[0][0]
    data = jax_augment({k: jnp.asarray(v) for k, v in jev.ds.canvas_batch(
        idx, canvas=jev.canvas, crop_aware=jev.crop_aware).items()},
        jax.random.PRNGKey(0), jev.spec, False)
    variables = {'params': jstate.params, 'batch_stats': jstate.batch_stats}
    forward = jax.jit(lambda x: jstate.apply_fn(variables, x, train=False)[-1])
    hm, hf = forward(data['image']), forward(data['image'][:, :, ::-1, :])
    hm = 0.5 * (hm + jax_flip(hf, jev.spec.flip_perm))
    want = jev._decode(hm, data['center'], data['scale'])
    have = tev._decode(*(torch.from_numpy(np.array(a)) for a in (hm, data['center'], data['scale'])))
    for a, b in zip(have, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_predict_keypoints_with_subset_matches_jax():
    subset = [0, 5]                                   # closed under the flip (0 <-> 5)
    over = dict(MODEL={'subset': subset, 'num_classes': 0})
    jstate = _jax_state(len(subset))
    tstate = _port_state(jstate, len(subset))
    jev = JaxEvaluator(jconfig.load_config(raw=_raw(**over)), verbose=False)
    tev = Evaluator(tconfig.load_config(raw=_raw(**over)), verbose=False, device='cpu')
    assert tev.flip_permutation(True) == (1, 0)
    got, gs = tev.predict_keypoints(tstate, return_scores=True)
    ref, rs = jev.predict_keypoints(jstate, return_scores=True)
    _close_keypoints(got, np.asarray(ref))
    off = [j for j in range(16) if j not in subset]
    assert not got[:, off].any() and not gs[:, off].any() and got[:, subset].any()
    bad = Evaluator(tconfig.load_config(raw=_raw(MODEL={'subset': [0, 1], 'num_classes': 0})),
                    verbose=False, device='cpu')
    with pytest.raises(ValueError, match='flip'):
        bad.predict_keypoints(tstate, flip_test=True)
    assert bad.flip_permutation(False) == (0, 1)


def test_evaluate_official_oks_matches_jax(full, jax_predictions, tmp_path, monkeypatch):
    jev, jstate, tev, tstate = full
    got = tev.evaluate_official(tstate, output_dir=str(tmp_path))
    # the JAX table from the JAX Evaluator's own flip-test predictions
    monkeypatch.setattr(jev, 'predict_keypoints', lambda *a, **k: jax_predictions)
    ref = jev.evaluate_official(jstate, output_dir=str(tmp_path))
    assert got.keys() == ref.keys() == {'AR', 'AR50', 'AR75', 'mean_oks'}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    assert tev.ds.scale_stored_expand == 1.0


def test_evaluator_on_host_crops_matches_jax(jstate16):
    """DATASET.device_pipeline=false: the cv2 host crops, normalised on the
    device, in `evaluate` (targets by prepare_host_batch) and in the
    flip-test `predict_keypoints` (center and scale from the batch)."""
    raw = _raw(DATASET={'device_pipeline': False})
    jev = JaxEvaluator(jconfig.load_config(raw=raw), verbose=False)
    tev = Evaluator(tconfig.load_config(raw=raw), verbose=False, device='cpu')
    tstate = _port_state(jstate16, 16)
    assert not tev.device_pipeline
    loss, acc = tev.evaluate(tstate)
    ref_loss, ref_acc = jev.evaluate(jstate16)
    assert np.isfinite(loss) and abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert abs(acc - ref_acc) <= 1.0 / (N * 16)
    got = tev.predict_keypoints(tstate)
    _close_keypoints(got, np.asarray(jev.predict_keypoints(jstate16)))


def test_evaluate_only_fails_fast_without_a_checkpoint(tmp_path, monkeypatch):
    """A missing checkpoint raises FileNotFoundError before any dataset is
    built."""
    def no_dataset(*args, **kwargs):
        raise AssertionError('a dataset was built')
    monkeypatch.setattr(evaluator_mod, 'get_dataset', no_dataset)
    for resume in (str(tmp_path / 'missing'), ''):
        with pytest.raises(FileNotFoundError):
            train_and_evaluate.main([TINY, 'COMMON.evaluate_only=true',
                                     f'COMMON.resume={resume}', '--device', 'cpu'])


# --- the Estimator

def _f32(model):
    """Compute in f32 (the JAX Estimator's model is swapped alike)."""
    for m in model.modules():
        if hasattr(m, 'compute_dtype'):
            m.compute_dtype = torch.float32
    return model


@pytest.fixture(scope='module')
def estimators(jstate16):
    jstate = jstate16
    jvars = {'params': jax.tree.map(np.asarray, jstate.params),
             'batch_stats': jax.tree.map(np.asarray, jstate.batch_stats)}
    jcfg, tcfg = jconfig.load_config(raw=_raw()), tconfig.load_config(raw=_raw())
    jest = JaxEstimator(jcfg, jvars['params'], jvars['batch_stats'])
    jest.model = JaxNet(num_stacks=1, num_blocks=1, num_classes=16, dtype=jnp.float32)
    test = Estimator(tcfg, variables=jvars, device='cpu')
    _f32(test.model)
    return jest, test, jvars


def test_estimator_post_process_matches_jax(estimators, rng):
    jest, test, _ = estimators
    hm = rng.uniform(0, 0.05, size=(3, 16, 16, 16)).astype(np.float32)
    for b in range(3):
        for j in range(16):
            hm[b, rng.randint(1, 15), rng.randint(1, 15), j] = 1.0 + rng.uniform()
    hm[0, 3, 2, 0] = hm[0, 9, 12, 0] = 3.0           # a tie
    for size in ((80, 48), (256, 256)):
        for strict in (False, True):
            got, gm = test.post_process_v2(hm, size, strict_reference=strict)
            ref, rm = jest.post_process_v2(hm, size, strict_reference=strict)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(ref))
            np.testing.assert_array_equal(gm, np.asarray(rm))
        got, gm = test.post_process_v1(hm, size)
        ref, rm = jest.post_process_v1(hm, size)
        np.testing.assert_array_equal(got, np.asarray(ref))
        np.testing.assert_array_equal(gm, np.asarray(rm))


@pytest.mark.parametrize('device_preprocess', [True, False])
def test_estimator_run_batch_matches_jax(estimators, rng, device_preprocess):
    jest, test, _ = estimators
    frames = rng.randint(0, 256, size=(3, 48, 80, 3)).astype(np.uint8)
    got = test._heatmaps(frames, device_preprocess).numpy()
    ref = np.asarray(jest._heatmaps(frames, device_preprocess))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    kps, ref_kps = test.run_batch(frames, device_preprocess), jest.run_batch(frames, device_preprocess)
    d = np.abs(kps - ref_kps).max(-1)
    assert (d == 0).mean() >= 0.98 and d.max() <= 80 / 16, d
    one = test.run(frames[0], time_it=False, device_preprocess=device_preprocess)
    np.testing.assert_array_equal(one, kps[0])
    peaks, shape = test.run_skeleton(frames[0], device_preprocess)
    ref_peaks, ref_shape = jest.run_skeleton(frames[0], device_preprocess)
    assert shape == ref_shape == (16, 16)
    np.testing.assert_array_equal(peaks[:, :2], ref_peaks[:, :2])


def test_estimator_weights_and_stats(estimators, tmp_path):
    jest, test, jvars = estimators
    assert Estimator._joints_for('mscoco') == Estimator._joints_for('coco') == 17
    assert Estimator._joints_for('synthetic') == JaxEstimator._joints_for('synthetic')
    with pytest.raises(ValueError, match='num_classes'):
        Estimator._joints_for('')
    for name in ('mpii', 'coco', 'merl3000', 'synthetic'):
        raw = _raw(COMMON={'dataset': name}, MODEL={'num_classes': 16})
        for strict in (False, True):
            got = Estimator(tconfig.load_config(raw=raw), variables=jvars, device='cpu',
                            strict_reference_stats=strict)
            ref = JaxEstimator(jconfig.load_config(raw=raw), jvars['params'],
                               jvars['batch_stats'], strict_reference_stats=strict)
            assert (got.mean, got.std) == (ref.mean, ref.std), (name, strict)
    assert Estimator(tconfig.load_config(raw=_raw(COMMON={'dataset': 'mpii'})),
                     variables=jvars, device='cpu',
                     strict_reference_stats=True).mean == ESTIMATOR_MEANSTD['mpii'][0]
    # weights from a port checkpoint (COMMON.resume), or none at all
    from hourglass_pose_estimation_torch.runner import checkpoint
    path = str(tmp_path / 'ckpt')
    checkpoint.save(path, init_state(test.model, make_optimizer(1e-3, [], 0.1, 1)), 1, 0.0)
    again = Estimator(tconfig.load_config(raw=_raw(COMMON={'resume': path})), device='cpu')
    for k, v in test.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        Estimator(tconfig.load_config(raw=_raw()), device='cpu')


def test_inference_fn_dark_matches_jax(estimators, rng):
    """The DARK decode in `make_inference_fn`. The two functions' heatmaps
    agree to f32 noise, and the quarter decode of such heatmaps is exact.
    DARK's Newton step divides by a finite-difference Hessian of the log of
    the blurred map; on the flat maps of random weights some peaks' Hessians
    are nearly singular, and there the last bits of the blur (its taps
    summed in another order than XLA's) or of the heatmaps move the step by
    more than 1e-3 px. On the port function's own heatmaps: at least 98% of
    the joints within 1e-3 px of the JAX decode (read 126 of 128) and every
    one within a heatmap pixel. End to end: every joint within a heatmap
    pixel and at least 90% within 1e-3 px (read 94.5% to 97.3%, at most
    0.14 px apart, over 4 seeds of 16 frames)."""
    _, test, jvars = estimators
    frames = rng.randint(0, 256, size=(8, 48, 80, 3)).astype(np.uint8)
    pre = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
    jnet = JaxNet(num_stacks=1, num_blocks=1, num_classes=16, dtype=jnp.float32)
    build = lambda decode: make_inference_fn(test.model, jvars, decode=decode, fold_bn=True,
                                             preprocess=pre, input_res=64, device='cpu')
    jfn = jax_inference_fn(jnet, jvars, decode='dark', fold_bn=True, preprocess=pre,
                           input_res=64)
    (got, gm), (ref, rm) = build('dark')(frames), jfn(jnp.asarray(frames))
    hm = build(None)(frames).numpy()
    ref_hm = np.asarray(jax_inference_fn(jnet, jvars, fold_bn=True, preprocess=pre,
                                         input_res=64)(jnp.asarray(frames)))
    np.testing.assert_allclose(hm, ref_hm, rtol=0, atol=1e-5 * np.abs(ref_hm).max())
    box = (np.full((8, 2), 32.0, np.float32), np.full((8, 2), 64 / 200.0, np.float32))
    want, _ = jdecode.decode_dark(jnp.asarray(hm), *box, zero_based=True)
    _close_keypoints(got.numpy(), np.asarray(want))
    d = np.abs(got.numpy() - np.asarray(ref)).max(-1)
    assert (d <= 1e-3).mean() >= 0.9 and d.max() <= PIXEL, np.sort(d.ravel())[-5:]
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(rm)).max())
    with pytest.raises(ValueError, match='decode'):
        make_inference_fn(test.model, jvars, decode='argmax', device='cpu')


def test_estimate_cli_draws_keypoints_and_skeleton(estimators, tmp_path, rng, capsys):
    """The estimate CLI on the CPU from a port checkpoint: a small jpg in,
    circles at the Estimator's keypoints out, and with COMMON.skeleton the
    NMS peaks' skeleton as the JAX package's visualizer draws the same
    peaks. `render_kps` and `draw_skeleton` against the JAX visualizer at
    16 and 17 joints."""
    cv2 = pytest.importorskip('cv2')
    import yaml
    from hourglass_pose_estimation_tpu.utils import visualize as jvis
    from hourglass_pose_estimation_torch import estimate
    from hourglass_pose_estimation_torch.runner import checkpoint
    from hourglass_pose_estimation_torch.utils import visualize as tvis
    _, test, _ = estimators
    ckpt = str(tmp_path / 'ckpt')
    checkpoint.save(ckpt, init_state(test.model, make_optimizer(1e-3, [], 0.1, 1)), 1, 0.0)
    cfg = tmp_path / 'estimate.yaml'
    cfg.write_text(yaml.safe_dump(_raw()))
    src = str(tmp_path / 'frame.jpg')
    assert cv2.imwrite(src, rng.randint(0, 256, size=(48, 80, 3)).astype(np.uint8))
    frame = cv2.imread(src)
    for skeleton in (False, True):
        dest = str(tmp_path / f'out_{skeleton}.png')
        over = [f'COMMON.resume={ckpt}', f'COMMON.image_path={src}',
                f'COMMON.dest_path={dest}', f'COMMON.skeleton={skeleton}']
        assert estimate.main([str(cfg)] + over + ['--device', 'cpu']) == 0
        assert f'wrote {dest}' in capsys.readouterr().out
        est = Estimator(tconfig.load_config(str(cfg), overrides=over), device='cpu')
        want = frame.copy()
        if skeleton:
            peaks, (hm_h, hm_w) = est.run_skeleton(frame)
            jvis.draw_skeleton(want, peaks, scale_x=frame.shape[1] / (hm_w * 4.0),
                               scale_y=frame.shape[0] / (hm_h * 4.0))
        else:
            for x, y in est.run(frame, time_it=False):
                cv2.circle(want, center=(int(x), int(y)), color=(0, 0, 255),
                           radius=5, thickness=-1)
        got = cv2.imread(dest)
        assert not np.array_equal(want, frame)
        np.testing.assert_array_equal(got, want)
    for joints in (16, 17):
        peaks = np.concatenate([rng.uniform(0, 16, size=(joints, 2)),
                                rng.uniform(0, 0.02, size=(joints, 1))], 1)
        for fn in ('render_kps', 'draw_skeleton'):
            got = getattr(tvis, fn)(frame.copy(), peaks, scale_x=1.25, scale_y=0.75)
            want = getattr(jvis, fn)(frame.copy(), peaks, scale_x=1.25, scale_y=0.75)
            np.testing.assert_array_equal(got, want)


def test_evaluator_and_estimator_need_cuda_unless_cpu_is_asked(estimators, monkeypatch):
    """Their entry points run on the card unless the caller asks for the
    CPU: without a card they raise, with no quiet CPU path."""
    _, _, jvars = estimators
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = tconfig.load_config(raw=_raw())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(cfg, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Estimator(cfg, variables=jvars)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_and_evaluate.main([TINY, 'COMMON.evaluate_only=true', f'COMMON.resume={TINY}'])
