"""Port input pipeline and optimizer vs the JAX package, on the CPU: the
affine warps on uint8 canvases, `augment_batch` with the JAX draws
injected, `Synthetic.canvas_batch`, RMSprop with its step schedule, and
the weights carried back under the flax names."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu.data import Synthetic as JaxSynthetic
from hourglass_pose_estimation_tpu.data import make_spec as jax_make_spec
from hourglass_pose_estimation_tpu.data.pipeline import (
    augment_batch as jax_augment, sample_augmentations as jax_sample)
from hourglass_pose_estimation_tpu.models import HourglassNet as JaxNet
from hourglass_pose_estimation_tpu.ops import warp as jwarp
from hourglass_pose_estimation_tpu.runner.train_state import (
    make_optimizer as jax_make_optimizer)
from hourglass_pose_estimation_tpu.utils.transforms import (
    batched_affine_transforms as jax_affines)

from hourglass_pose_estimation_torch.data import (
    Synthetic, augment_batch, make_spec, sample_augmentations, to_device)
from hourglass_pose_estimation_torch.models import HourglassNet
from hourglass_pose_estimation_torch.ops import warp as twarp
from hourglass_pose_estimation_torch.runner import make_optimizer
from hourglass_pose_estimation_torch.weights import (
    load_jax_variables, to_jax_variables)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream: the session-wide `rng` of conftest.py
    is shared by every file a test worker runs, so its draws here would
    depend on which files ran before."""
    return np.random.RandomState(0)

DS_KW = dict(num_samples=6, inp_res=64, out_res=16, sigma=1,
             scale_factor=0.25, rot_factor=30)


def _canvas(rng, B=3, S=40):
    return rng.randint(0, 256, size=(B, S, S, 3)).astype(np.uint8)


def _inv_affines(rng, B, rot=True):
    centers = rng.uniform(10, 30, size=(B, 2)).astype(np.float32)
    scales = rng.uniform(0.1, 0.3, size=(B,)).astype(np.float32)
    rots = (rng.uniform(-60, 60, size=(B,)) if rot else np.zeros(B)).astype(np.float32)
    inv = np.array(jax_affines(centers, scales, rots, (32, 32), inv=True))
    inv[0, 0, :] *= [-1, -1, 1]            # a flip folds into a negative x-scale
    inv[0, 0, 2] = 45.0
    inv[-1, :, 2] -= 15.0                  # taps off the canvas
    return inv


# XLA on the CPU contracts the source-coordinate multiply-adds into FMAs,
# which moves a source coordinate (|sx| < 64) by up to an f32 ulp (4e-6) and
# each bilinear weight by as much: up to 255 * 8e-6 = 2e-3 of a uint8 value.
WARP_ATOL = 2e-3


def test_affine_warp_matches_jax_on_uint8(rng):
    """The same taps and lerp order as the JAX gather warp, with rotation,
    a flip and taps off the canvas."""
    img = _canvas(rng)
    inv = _inv_affines(rng, 3)
    ref = np.asarray(jwarp.affine_warp(img, inv, (32, 28)))
    got = twarp.affine_warp(torch.from_numpy(img), torch.from_numpy(inv), (32, 28))
    assert got.shape == (3, 28, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=WARP_ATOL)
    assert (got.numpy() == 0).any()        # the off-canvas taps are zero
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)


def test_affine_warp_separable_matches_jax(rng):
    img = _canvas(rng)
    inv = _inv_affines(rng, 3, rot=False)
    ref = np.asarray(jwarp.affine_warp_separable(img, inv, (32, 32)))
    got = twarp.affine_warp_separable(torch.from_numpy(img),
                                      torch.from_numpy(inv), (32, 32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=WARP_ATOL)
    # against the port's gather warp: two non-zero terms of the one-hot
    # products, rounded in another order
    gather = twarp.affine_warp(torch.from_numpy(img), torch.from_numpy(inv), (32, 32))
    np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=1e-6, atol=1e-4)


def test_synthetic_canvas_batch_equals_jax():
    ours = Synthetic(True, **DS_KW)
    ref = JaxSynthetic(True, **DS_KW)
    idx = [4, 0, 2]
    a, b = ours.canvas_batch(idx, canvas=64), ref.canvas_batch(idx, canvas=64)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    assert make_spec(ours) == tuple(jax_make_spec(ref))
    # q = 96/64: the whole image through cv2's resize, as in the JAX package
    a, b = ours.canvas_batch(idx, canvas=96), ref.canvas_batch(idx, canvas=96)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert float(a['canvas_scale'][0]) == 1.5


@pytest.mark.parametrize('train', [True, False])
def test_augment_batch_with_injected_draws_matches_jax(train):
    ds = Synthetic(True, **DS_KW)
    spec = make_spec(ds)
    raw = ds.canvas_batch([0, 1, 2, 3, 5], canvas=64)
    key = jax.random.PRNGKey(3)
    ref = jax_augment(raw, key, spec, train)
    draws = jax_sample(key, jnp.asarray(raw['scale']),
                       scale_factor=spec.scale_factor,
                       rot_factor=spec.rot_factor, train=train)
    draws = tuple(torch.from_numpy(np.array(d)) for d in draws)
    if train:
        assert bool(draws[2].any()) and bool((draws[1] != 0).any())
    got = augment_batch(to_device(raw, 'cpu'), draws, spec, train)
    # the crop affines agree to f32 rounding of sin/cos (~1e-6 relative),
    # which moves each bilinear tap weight by ~1e-5 of a pixel value
    np.testing.assert_allclose(got['joints_input'].numpy(),
                               np.asarray(ref['joints_input']), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got['image'].numpy(), np.asarray(ref['image']),
                               rtol=0, atol=2e-3)
    np.testing.assert_array_equal(got['target_weight'].numpy(),
                                  np.asarray(ref['target_weight']))
    np.testing.assert_allclose(got['target'].numpy(), np.asarray(ref['target']),
                               rtol=0, atol=1e-6)
    for k in ('center', 'scale', 'rotation'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6)


def test_sample_augmentations_distributions():
    """The draws follow the reference distributions: flips at p = 0.5,
    rotation at p = 0.6 within +-2 rf, scale jitter within 1 +- sf."""
    B = 20000
    gen = torch.Generator().manual_seed(0)
    scales = torch.ones(B, 2)
    s, r, f = sample_augmentations(gen, scales, scale_factor=0.25,
                                   rot_factor=30, train=True)
    assert abs(float(f.float().mean()) - 0.5) < 0.02
    assert abs(float((r != 0).float().mean()) - 0.6) < 0.02
    assert float(r.abs().max()) <= 60 and float(r[r != 0].std()) > 20
    assert 0.75 <= float(s.min()) and float(s.max()) <= 1.25
    assert abs(float(s[:, 0].mean()) - 1.0) < 0.01
    assert bool((r[f] != 0).all())         # every flip also rotates
    s0, r0, f0 = sample_augmentations(None, scales, scale_factor=0.25,
                                      rot_factor=30, train=False)
    assert torch.equal(s0, scales) and not r0.any() and not f0.any()


def test_rmsprop_and_schedule_match_optax(rng):
    """torch.optim.RMSprop under the step schedule tracks the optax chain
    of `make_optimizer`, across both decay boundaries."""
    w0 = rng.normal(size=(6,)).astype(np.float32)
    tx = jax_make_optimizer(0.01, [2, 3], 0.1, 3)
    ours = make_optimizer(0.01, [2, 3], 0.1, 3)
    w = jnp.asarray(w0)
    opt_state = tx.init(w)
    wt = torch.tensor(w0, requires_grad=True)
    opt = ours.build([wt])
    for step in range(12):
        g = np.cos(np.arange(6) + step).astype(np.float32) * (step + 1)
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = w + upd
        wt.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group['lr'] = ours.lr(step)
        opt.step()
        np.testing.assert_allclose(wt.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7, err_msg=f'step {step}')
    assert [ours.lr(s) for s in (5, 6, 8, 9)] == pytest.approx(
        [0.01, 0.001, 0.001, 0.0001])


def test_to_jax_variables_round_trips_flax_tree():
    jmodel = JaxNet(num_stacks=1, num_classes=4, num_feats=16, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)))
    model = HourglassNet(num_stacks=1, num_classes=4, num_feats=16)
    back = to_jax_variables(load_jax_variables(model, v))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(v))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
