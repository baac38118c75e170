"""Port ops vs the JAX package: the plain versions of the three Hopper
kernels against the Pallas kernels (interpret mode) and their XLA
oracles, plus resize and the affine geometry. f32 on the CPU; inputs
from seeded numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu.models.modules import (
    upsample2x_nearest as jax_upsample2x_nearest)
from hourglass_pose_estimation_tpu.ops import decode as jdecode
from hourglass_pose_estimation_tpu.ops import resize as jresize
from hourglass_pose_estimation_tpu.ops.pallas import (
    decode_peaks_pallas, upsample2x_add_pallas)
from hourglass_pose_estimation_tpu.ops.pallas import bottleneck as jbneck
from hourglass_pose_estimation_tpu.utils import transforms as jtf

from hourglass_pose_estimation_torch.ops import decode as tdecode
from hourglass_pose_estimation_torch.ops import resize as tresize
from hourglass_pose_estimation_torch.ops.hopper import bottleneck as tbneck
from hourglass_pose_estimation_torch.ops.hopper import (
    decode_peaks, upsample2x_add)
from hourglass_pose_estimation_torch.ops.hopper.decode import (
    MAX_CLUSTER, decode_schedule)
from hourglass_pose_estimation_torch.utils import transforms as ttf

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream: the session-wide `rng` of conftest.py
    is shared by every file a test worker runs, so its draws here would
    depend on which files ran before."""
    return np.random.RandomState(0)


def _jax_params_to_port(params):
    """JAX BottleneckParams -> port BottleneckParams through the port's
    `params_from_variables` (the folded a/b fed in as BN scale/bias with
    identity statistics, eps=0)."""
    p = jax.tree.map(np.asarray, params)
    ident = lambda n: {'mean': np.zeros(n, np.float32),
                       'var': np.ones(n, np.float32)}
    C, P = p.w1.shape
    block = {
        'params': {
            'bn1': {'scale': p.a1, 'bias': p.b1},
            'bn2': {'scale': p.a2, 'bias': p.b2},
            'bn3': {'scale': p.a3, 'bias': p.b3},
            'conv1': {'kernel': p.w1[None, None], 'bias': p.c1},
            'conv2': {'kernel': p.w2, 'bias': p.c2},
            'conv3': {'kernel': p.w3[None, None], 'bias': p.c3}},
        'batch_stats': {'bn1': ident(C), 'bn2': ident(P), 'bn3': ident(P)}}
    return tbneck.params_from_variables(block, eps=0.0, dtype=torch.float32)


@pytest.mark.parametrize('H,W', [(16, 16), (17, 24), (32, 16)])
def test_bottleneck_plain_matches_pallas_and_xla(rng, H, W):
    params = jbneck.random_params(jax.random.PRNGKey(H), 32, 16,
                                  dtype=jnp.float32)
    x = rng.normal(size=(2, H, W, 32)).astype(np.float32)
    pallas = np.asarray(jbneck.fused_bottleneck_pallas(
        jnp.asarray(x), params, interpret=True))
    xla = np.asarray(jbneck.bottleneck_reference(jnp.asarray(x), params))
    got = tbneck.fused_bottleneck(torch.from_numpy(x),
                                  _jax_params_to_port(params)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_bottleneck_params_from_variables_matches_jax(rng):
    """The port's fold of real BN statistics equals the JAX fold, and
    stores every weight output-channel-major for the kernel."""
    from hourglass_pose_estimation_tpu.models.modules import Bottleneck
    blk = Bottleneck(planes=16, dtype=jnp.float32)
    x = jnp.asarray(rng.normal(size=(2, 8, 8, 32)).astype(np.float32))
    v = blk.init(jax.random.PRNGKey(0), x, train=True)
    _, mut = blk.apply(v, x, train=True, mutable=['batch_stats'])
    v = jax.tree.map(np.asarray, {'params': v['params'],
                                  'batch_stats': mut['batch_stats']})
    ref = jbneck.params_from_variables(v, dtype=jnp.float32)
    got = tbneck.params_from_variables(v, dtype=torch.float32)
    for name, a, b in zip(ref._fields, ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if name.startswith('w'):
            assert b.transpose(-1, -2).is_contiguous(), name


@pytest.mark.parametrize('H,W,C', [(8, 8, 32), (12, 12, 32), (3, 5, 8)])
def test_upsample_add_plain_matches_pallas_exactly(rng, H, W, C):
    low = rng.normal(size=(2, H, W, C)).astype(np.float32)
    skip = rng.normal(size=(2, 2 * H, 2 * W, C)).astype(np.float32)
    pallas = np.asarray(upsample2x_add_pallas(jnp.asarray(low),
                                              jnp.asarray(skip), True))
    xla = np.asarray(jax_upsample2x_nearest(jnp.asarray(low)) + skip)
    got = upsample2x_add(torch.from_numpy(low), torch.from_numpy(skip)).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


def _decode_maps(rng):
    """Random maps with planted edge peaks, ties and zero gradients."""
    hm = rng.uniform(0, 1, size=(3, 16, 16, 6)).astype(np.float32)
    hm[0, 0, 7, 0] = 5.0                     # top edge: no offset
    hm[0, 9, 15, 1] = 5.0                    # right edge
    hm[1, 4, 4, 2] = 5.0; hm[1, 11, 2, 2] = 5.0     # tie: first row-major
    hm[1, 6, 6, 3] = 5.0; hm[1, 6, 5, 3] = 2.0; hm[1, 6, 7, 3] = 2.0  # gx == 0
    hm[2, 8, 8, 4] = 5.0; hm[2, 7, 8, 4] = 1.0; hm[2, 9, 8, 4] = 1.0  # gy == 0
    hm[2, :, :, 5] = 0.0                     # flat map: argmax (0, 0)
    return hm


def test_decode_plain_matches_pallas_exactly(rng):
    hm = _decode_maps(rng)
    jc, jm = decode_peaks_pallas(hm, interpret=True)
    tc, tm = decode_peaks(torch.from_numpy(hm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tc[1, 2].tolist()[:2] == [4.0 + np.sign(hm[1, 4, 5, 2] - hm[1, 4, 3, 2]) * 0.25,
                                     4.0 + np.sign(hm[1, 5, 4, 2] - hm[1, 3, 4, 2]) * 0.25]
    assert tc[0, 0].tolist() == [7.0, 0.0]
    assert tc[2, 5].tolist() == [0.0, 0.0]


def test_decode_quarter_offset_matches_xla(rng):
    hm = _decode_maps(rng)
    B = hm.shape[0]
    centers = rng.uniform(20, 60, size=(B, 2)).astype(np.float32)
    scales = rng.uniform(0.2, 0.6, size=(B, 2)).astype(np.float32)
    jk, jm = jdecode.decode_quarter_offset(hm, centers, scales,
                                           zero_based=True)
    tk, tm = tdecode.decode_quarter_offset(torch.from_numpy(hm), centers,
                                           scales, zero_based=True)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jc, jv = jdecode.get_preds_zero_based(jnp.asarray(hm))
    tc, tv = tdecode.get_preds_zero_based(torch.from_numpy(hm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --- NaN. The port follows the XLA decoder, which the JAX serving function
# runs (`export/__init__.py` decodes with decode_quarter_offset(zero_based=
# True)): its argmax, like torch.argmax, ranks NaN above every number and
# takes the first NaN, its maxval is NaN, and jnp.sign keeps a NaN
# gradient (torch.sign gives 0, so the plain version keeps the NaN
# itself). The Pallas kernel, which only tools and tests call, has a third
# behaviour: with a NaN max its `hm >= max` holds nowhere, idx = H*W, and
# the coords read (0, H).

def _nan_maps(case, J):
    """Maps from their own stream, so the module `rng`'s draws that later
    tests in this file take do not depend on these cases."""
    hm = np.random.RandomState(J).uniform(0, 1, size=(2, 16, 20, J)).astype(np.float32)
    if case == 'nan_among_numbers':            # beats a larger finite peak
        hm[0, 9, 9, 0] = 5.0
        hm[0, 5, 7, 0] = np.nan
        hm[1, 12, 3, J - 1] = np.nan
    elif case == 'nan_beside_peak':            # the NaN wins; the peak is its neighbour
        hm[0, 9, 9, 1] = 5.0
        hm[0, 9, 10, 1] = np.nan
    elif case == 'nan_pair':                   # the first wins; the second makes gx NaN
        hm[1, 6, 6, 2] = hm[1, 6, 7, 2] = np.nan
    elif case == 'all_nan':                    # argmax 0: the edge gate is shut
        hm[1, :, :, 3] = np.nan
    return hm


@pytest.mark.parametrize('J', [16, 17])
@pytest.mark.parametrize('case', ['nan_among_numbers', 'nan_beside_peak', 'nan_pair', 'all_nan'])
def test_decode_nan_matches_xla(case, J):
    """The plain decode against the XLA decode_quarter_offset(zero_based=
    True) and get_preds_zero_based on maps holding NaN: equal bits, NaN in
    the same places (at the affine of a box the map's own size, and at the
    serving function's 256^2 one)."""
    hm = _nan_maps(case, J)
    B = hm.shape[0]
    for center, scale in (((10.0, 8.0), (0.1, 0.08)), ((128.0, 128.0), (1.28, 1.28))):
        centers = np.tile(np.array(center, np.float32), (B, 1))
        scales = np.tile(np.array(scale, np.float32), (B, 1))
        jk, jm = jdecode.decode_quarter_offset(hm, centers, scales, zero_based=True)
        tk, tm = tdecode.decode_quarter_offset(torch.from_numpy(hm), centers, scales,
                                               zero_based=True)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.isnan(tm.numpy()).any()
    if case == 'nan_pair':
        assert np.isnan(tk.numpy()[1, 2]).all()       # x NaN, then both through the affine
    if case == 'all_nan':
        pc, _ = decode_peaks(torch.from_numpy(hm))
        assert pc[1, 3].tolist() == [0.0, 0.0]
    jc, jv = jdecode.get_preds_zero_based(jnp.asarray(hm))
    tc, tv = tdecode.get_preds_zero_based(torch.from_numpy(hm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize('B', [1, 37, 48, 60, 64])
@pytest.mark.parametrize('H', [12, 16, 64])
def test_decode_schedule_covers_every_row_once(H, B):
    """The kernel's launch, a pure function of the shape: at most 8 blocks
    an image (a portable cluster), every row in exactly one block's slab,
    no empty block, and L * T a multiple of J (each thread's lanes keep
    their joints); at the flagship [B, 64, 64, 16] 8 blocks of 8 rows at
    batch 1, 7, 6 and 5 blocks at the partial serving batches 37, 48 and
    60, and 4 blocks of 16 rows at batch 64 (about 256 blocks)."""
    for W, J in ((64, 16), (64, 17), (13, 17), (20, 16)):
        K, rows, T, L = decode_schedule(B, H, W, J)
        assert 1 <= K <= MAX_CLUSTER and rows >= 1
        slabs = [range(k * rows, min(H, (k + 1) * rows)) for k in range(K)]
        assert all(len(s) > 0 for s in slabs)
        assert sorted(r for s in slabs for r in s) == list(range(H))
        assert L == (4 if W * J % 4 == 0 else 1) and (L * T) % J == 0 and 32 <= T <= 1024
        assert decode_schedule(B, H, W, J, aligned=False)[3] == 1
    assert decode_schedule(B, 64, 64, 16) == {1: (8, 8, 256, 4), 37: (7, 10, 256, 4),
                                              48: (6, 11, 256, 4), 60: (5, 13, 256, 4),
                                              64: (4, 16, 256, 4)}[B]
    assert decode_schedule(B, 12, 64, 16)[:2] == (3, 4)


@pytest.mark.parametrize('shape,out', [((2, 80, 96, 3), (64, 64)),
                                       ((1, 30, 20, 3), (64, 48)),
                                       ((1, 64, 64, 3), (64, 64))])
def test_resize_halfpix_matches_jax(rng, shape, out):
    x = rng.uniform(0, 1, size=shape).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear_halfpix(jnp.asarray(x), out))
    got = tresize.resize_bilinear_halfpix(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('inv', [False, True])
def test_batched_affine_matches_jax(rng, inv):
    B = 4
    centers = rng.uniform(0, 300, size=(B, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, size=(B,)).astype(np.float32)
    rots = rng.uniform(-30, 30, size=(B,)).astype(np.float32)
    pts = rng.uniform(0, 64, size=(B, 5, 2)).astype(np.float32)
    ref_t = jtf.batched_affine_transforms(centers, scales, rots, (64, 48),
                                          inv=inv)
    got_t = ttf.batched_affine_transforms(centers, scales, rots, (64, 48),
                                          inv=inv)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-5,
                               atol=1e-4)
    ref = jtf.batched_apply_affine(pts, ref_t)
    got = ttf.batched_apply_affine(torch.from_numpy(pts), got_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
