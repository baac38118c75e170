"""Port training ops vs the JAX package, f32 on the CPU with seeded numpy
inputs: train-mode BatchNorm (the module, and the fused BatchNorm's
autograd Function over its ops' plain versions, with the ReLU and the
cast the call sites apply), the loss and PCK, and the plain versions
(and autograd Functions) of the training kernels: the Gaussian render,
the 2x2 max-pool forward and backward (both tie modes: the Pallas
kernel's split, and the model's first maximum against `jax.grad` of
`nn.max_pool`), the upsample backward and the fused bottleneck's backward.
Pallas kernels run in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from hourglass_pose_estimation_tpu.loss import heatmap_mse_loss as jax_loss
from hourglass_pose_estimation_tpu.models.norm import BatchNorm as JaxBN
from hourglass_pose_estimation_tpu.ops.heatmap import (
    render_gaussian_targets as jax_render)
from hourglass_pose_estimation_tpu.ops.pallas import (
    maxpool2x2_pallas, render_gaussian_targets_pallas, upsample2x_add_pallas)
from hourglass_pose_estimation_tpu.ops.pallas import bottleneck as jbneck
from hourglass_pose_estimation_tpu.utils import evaluation as jeval

from hourglass_pose_estimation_torch.loss import heatmap_mse_loss
from hourglass_pose_estimation_torch.models.norm import BatchNorm
from hourglass_pose_estimation_torch.ops.heatmap import render_gaussian_targets
from hourglass_pose_estimation_torch.ops.hopper import (
    BottleneckParams, StatRows, batch_moments_reference, batch_norm_reference,
    batch_norm_train, batch_stats_reference, bottleneck_backward_reference, fused_bottleneck,
    maxpool2x2, maxpool2x2_bwd_first_reference, running_update_reference, upsample2x_add)
from hourglass_pose_estimation_torch.models.modules import max_pool
from hourglass_pose_estimation_torch.utils import evaluation as teval

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def rng():
    """This file's own seeded stream: the session-wide `rng` of conftest.py
    is shared by every file a test worker runs, so its draws here would
    depend on which files ran before."""
    return np.random.RandomState(0)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- train-mode BatchNorm: output and running statistics vs flax apply

@pytest.mark.parametrize('fast,k', [(True, 0), (False, 0), (True, 2), (False, 3)])
def test_batchnorm_train_matches_flax(rng, fast, k):
    C = 8
    x = (rng.normal(size=(4, 5, 6, C)) * 2 + 3).astype(np.float32)
    params = {'scale': rng.uniform(0.5, 1.5, C).astype(np.float32),
              'bias': rng.normal(size=C).astype(np.float32)}
    stats = {'mean': rng.normal(size=C).astype(np.float32),
             'var': rng.uniform(0.5, 2, C).astype(np.float32)}
    jbn = JaxBN(use_running_average=False, stat_samples=k, fast_variance=fast,
                dtype=jnp.float32)
    ref, mut = jbn.apply({'params': params, 'batch_stats': stats},
                         jnp.asarray(x), mutable=['batch_stats'])
    bn = BatchNorm(C, stat_samples=k, fast_variance=fast)
    with torch.no_grad():
        bn.weight.copy_(_t(params['scale']))
        bn.bias.copy_(_t(params['bias']))
        bn.running_mean.copy_(_t(stats['mean']))
        bn.running_var.copy_(_t(stats['var']))
    got = bn(_t(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    # f32 reductions in another order: a few ulps of the statistics
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut['batch_stats']['mean']),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut['batch_stats']['var']),
                               rtol=1e-5, atol=1e-6)
    # eval mode normalises with the updated running averages
    ev = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    jev = JaxBN(use_running_average=True, dtype=jnp.float32).apply(
        {'params': params, 'batch_stats': mut['batch_stats']}, jnp.asarray(x))
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(jev),
                               rtol=1e-5, atol=1e-5)


def _bn_case(rng, B=4, C=8, H=5, W=6):
    x = (rng.normal(size=(B, H, W, C)) * 2 + 3).astype(np.float32)
    params = {'scale': rng.uniform(0.5, 1.5, C).astype(np.float32),
              'bias': rng.normal(size=C).astype(np.float32)}
    stats = {'mean': rng.normal(size=C).astype(np.float32),
             'var': rng.uniform(0.5, 2, C).astype(np.float32)}
    return x, params, stats


# what the call sites apply after a train-mode BatchNorm, in JAX: the ReLU
# (or not) and the cast to the next op's dtype
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize('relu,out_dtype,k,update', [
    (True, torch.float32, 0, True), (False, torch.float32, 0, True),
    (True, torch.bfloat16, 0, True), (False, torch.bfloat16, 0, True),
    (True, torch.float32, 2, True), (False, torch.float32, 3, True),
    (True, torch.bfloat16, 2, True), (False, torch.bfloat16, 1, True),
    (True, torch.float32, 0, False), (True, torch.bfloat16, 2, False)])
def test_batchnorm_function_matches_flax(rng, relu, out_dtype, k, update):
    """The fused BatchNorm's autograd Function, on the CPU (its ops' plain
    versions), against the JAX BatchNorm followed by the ReLU and the cast:
    the output, dx, dweight, dbias and the running averages (moved only
    when `update`); the module's train-mode forward, which runs the
    Function, bit for bit; and autograd over the plain versions of the
    forward on the same inputs: the same output bits, running averages,
    dweight and dbias, and dx within an ulp (autograd adds two rounded
    contributions to dx, the Function's backward one f32 sum)."""
    x, params, stats = _bn_case(rng)
    B, H, W, C = x.shape
    jbn = JaxBN(use_running_average=False, stat_samples=k, dtype=jnp.float32)

    def jax_fn(xj, scale, bias):
        y, mut = jbn.apply({'params': {'scale': scale, 'bias': bias}, 'batch_stats': stats},
                           xj, mutable=['batch_stats'])
        return (jax.nn.relu(y) if relu else y).astype(_JNP[out_dtype]), mut

    ref, vjp, mut = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(params['scale']),
                            jnp.asarray(params['bias']), has_aux=True)
    g = rng.normal(size=ref.shape).astype(np.float32)
    g_t = _t(g).to(out_dtype)
    jdx, jdw, jdb = vjp(jnp.asarray(g_t.float().numpy()).astype(_JNP[out_dtype]))

    def run(how):
        bn = BatchNorm(C, stat_samples=k)
        bn.update_stats = update
        with torch.no_grad():
            bn.weight.copy_(_t(params['scale']))
            bn.bias.copy_(_t(params['bias']))
            bn.running_mean.copy_(_t(stats['mean']))
            bn.running_var.copy_(_t(stats['var']))
        xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
        n = k if 0 < k < B else B
        running = (bn.running_mean, bn.running_var) if update else None
        if how == 'function':
            y, _, _ = batch_norm_train(xt, bn.weight, bn.bias, StatRows(n, n * H * W, 1),
                                       running, bn.momentum, bn.eps, relu, out_dtype)
        elif how == 'module':
            y = bn(xt, train=True, relu=relu, out_dtype=out_dtype)
        else:
            mean, var = batch_stats_reference(batch_moments_reference(xt, n, n * H * W), 1.0)
            if update:
                running_update_reference(*running, mean, var, bn.momentum)
            y = batch_norm_reference(xt, mean, var, bn.weight, bn.bias, bn.eps, relu, out_dtype)
        y.backward(g_t.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1), xt.grad.permute(0, 2, 3, 1), bn

    got, dx, bn = run('function')
    assert got.dtype == out_dtype
    # f32 reductions in another order: a few ulps of the statistics, so a
    # bf16 output may land one bf16 step away
    tol = dict(rtol=1e-5, atol=1e-5) if out_dtype == torch.float32 else dict(rtol=2 ** -8,
                                                                             atol=2 ** -8)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32), **tol)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-5)
    want = mut['batch_stats'] if update else stats
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want['mean']),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want['var']),
                               rtol=1e-5, atol=1e-6)

    mod, mdx, mbn = run('module')
    assert torch.equal(got, mod) and torch.equal(dx, mdx)
    for name, t in mbn.state_dict().items():
        assert torch.equal(bn.state_dict()[name], t), name
    assert torch.equal(bn.weight.grad, mbn.weight.grad)
    assert torch.equal(bn.bias.grad, mbn.bias.grad)

    plain, pdx, pbn = run('plain')
    assert torch.equal(got, plain)
    assert torch.equal(bn.running_mean, pbn.running_mean)
    assert torch.equal(bn.running_var, pbn.running_var)
    assert torch.equal(bn.weight.grad, pbn.weight.grad)
    assert torch.equal(bn.bias.grad, pbn.bias.grad)
    np.testing.assert_allclose(dx.numpy(), pdx.numpy(), rtol=2 ** -23, atol=2 ** -22)


@pytest.mark.parametrize('relu,out_dtype', [(True, torch.bfloat16), (False, torch.float32)])
def test_batchnorm_module_relu_and_cast_match_the_call_sites(rng, relu, out_dtype):
    """`relu` and `out_dtype` are what the call sites applied after the
    module before: the same bits in train and eval mode; the train-mode
    forward of a CPU tensor runs the fused BatchNorm's autograd Function
    (its ops' plain versions), as a CUDA one runs its kernels."""
    x, params, stats = _bn_case(rng, C=16)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(_t(params['scale']))
        bn.bias.copy_(_t(params['bias']))
    for train in (True, False):
        bn.update_stats = False
        got = bn(xt, train, relu=relu, out_dtype=out_dtype)
        y = bn(xt, train)
        want = (torch.relu(y) if relu else y).to(out_dtype)
        assert y.dtype == torch.float32 and torch.equal(got, want)
        assert (type(got.grad_fn).__name__ == '_TrainBatchNormBackward') == train


@pytest.mark.parametrize('name', ['batch_norm_train_stats', 'batch_norm_train_fwd',
                                  'batch_norm_train_bwd_reduce', 'batch_norm_train_bwd'])
def test_batchnorm_op_fakes_give_the_kernels_shapes(name):
    """Each fused BatchNorm op's fake, on meta tensors: the output shapes,
    dtypes and (for activations) channels-last strides of the CPU kernel,
    and the kernel's refusals (an NCHW-strided activation)."""
    cl = torch.channels_last
    x = torch.randn(2, 16, 3, 4).contiguous(memory_format=cl)
    g = torch.randn(2, 16, 3, 4).to(torch.bfloat16).contiguous(memory_format=cl)
    w, b, m = torch.rand(16) + 0.5, torch.randn(16), torch.rand(2, 16)
    args = {'batch_norm_train_stats': (x, 1, 12.0),
            'batch_norm_train_fwd': (x, m, w, b, torch.zeros(16), torch.ones(16), 1.0, 0.9,
                                     1e-5, True, torch.bfloat16),
            'batch_norm_train_bwd_reduce': (g, x, m, w, b, 1.0, 1e-5, True),
            'batch_norm_train_bwd': (g, x, m, w, b, torch.randn(2, 16), 1, 12.0, 1.0, 1e-5,
                                     True)}[name]
    op = getattr(torch.ops.hpe, name)
    cpu = op(*args)
    meta = op(*(a.to('meta') if isinstance(a, torch.Tensor) else a for a in args))
    for c, f in zip(*(o if isinstance(o, tuple) else (o,) for o in (cpu, meta))):
        assert f.device.type == 'meta'
        assert (f.shape, f.dtype, f.stride()) == (c.shape, c.dtype, c.stride())
    with pytest.raises(ValueError, match='channels-last'):
        op(*(a.contiguous().to('meta') if isinstance(a, torch.Tensor) and a.dim() == 4
             else a.to('meta') if isinstance(a, torch.Tensor) else a for a in args))


@pytest.mark.parametrize('relu,k', [(True, 0), (False, 0), (True, 2), (False, 3)])
def test_batchnorm_function_rounds_a_bf16_dx_as_jax(rng, relu, k):
    """A bf16 activation's dx from the Function's plain versions rounds its
    two parts (the normalisation's and the statistics') to bf16 before the
    sum, as autograd over the plain forward and JAX's transpose of its two
    casts of x do: bit for bit against autograd, and on at least 99% of the
    elements against JAX (where the statistics' f32 sums round alike; one
    rounding of the f32 sum differs from JAX on ~15%)."""
    x, params, stats = _bn_case(rng)
    B, H, W, C = x.shape
    xb = _t(x).to(torch.bfloat16)
    g = _t(rng.normal(size=x.shape).astype(np.float32)).to(torch.bfloat16)
    jbn = JaxBN(use_running_average=False, stat_samples=k, dtype=jnp.float32)

    def jax_fn(xj):
        y, _ = jbn.apply({'params': {'scale': params['scale'], 'bias': params['bias']},
                          'batch_stats': stats}, xj, mutable=['batch_stats'])
        return (jax.nn.relu(y) if relu else y).astype(jnp.bfloat16)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    jdx = np.asarray(vjp(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))[0], np.float32)
    w, b = _t(params['scale']), _t(params['bias'])
    n = k if 0 < k < B else B
    dxs = []
    for fused in (True, False):
        xt = xb.permute(0, 3, 1, 2).detach().requires_grad_()
        if fused:
            y, _, _ = batch_norm_train(xt, w, b, StatRows(n, n * H * W, 1), None, 0.9, 1e-5,
                                       relu, torch.bfloat16)
        else:
            mean, var = batch_stats_reference(batch_moments_reference(xt, n, n * H * W), 1.0)
            y = batch_norm_reference(xt, mean, var, w, b, 1e-5, relu, torch.bfloat16)
        y.backward(g.permute(0, 3, 1, 2))
        assert xt.grad.dtype == torch.bfloat16
        dxs.append(xt.grad.permute(0, 2, 3, 1).float().numpy())
    np.testing.assert_array_equal(dxs[0], dxs[1])
    assert (dxs[0] == jdx).mean() >= 0.99


@pytest.mark.parametrize('what', ['nchw', 'channels', 'f16', 'f64'])
def test_batchnorm_module_refuses_what_the_kernels_do_not_take(what):
    """The train-mode module on meta tensors (the ops' fakes make the CUDA
    kernels' checks there) raises on an activation the kernels do not
    take: NCHW strides, C not a multiple of 8, f16 or f64. The module has
    no plain train-mode route to fall back on for a one-pass BatchNorm."""
    c = 12 if what == 'channels' else 16
    dtype = {'f16': torch.float16, 'f64': torch.float64}.get(what, torch.float32)
    x = torch.empty(2, c, 4, 4, device='meta', dtype=dtype)
    if what != 'nchw':
        x = x.contiguous(memory_format=torch.channels_last)
    bn = BatchNorm(c).to('meta')
    match = {'nchw': 'channels-last', 'channels': 'multiple of 8'}.get(what, 'dtype')
    with pytest.raises(ValueError, match=match):
        bn(x, True)


# --- loss and PCK

def test_loss_matches_jax(rng):
    out = rng.normal(size=(3, 4, 8, 8, 5)).astype(np.float32)
    tgt = rng.uniform(size=(4, 8, 8, 5)).astype(np.float32)
    tw = (rng.uniform(size=(4, 5)) > 0.3).astype(np.float32) * 0.7
    for w, use in ((tw, True), (None, False)):
        ref = float(jax_loss(jnp.asarray(out), jnp.asarray(tgt),
                             None if w is None else jnp.asarray(w), use))
        got = float(heatmap_mse_loss(_t(out), _t(tgt),
                                     None if w is None else _t(w), use))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    with pytest.raises(ValueError, match='target_weight'):
        heatmap_mse_loss(_t(out), _t(tgt), None)


def test_accuracy_matches_jax(rng):
    B, H, W, J = 6, 16, 16, 7
    out = rng.normal(size=(B, H, W, J)).astype(np.float32)
    tgt = np.zeros((B, H, W, J), np.float32)
    for b in range(B):
        for j in range(J):
            if rng.uniform() > 0.2:
                tgt[b, rng.randint(H), rng.randint(W), j] = 1.0
    out[0, 0, 0, 0] = 50.0                 # flat index 0: the (W, 0) quirk
    out[1, :, :, 1] = -1.0                 # max <= 0: prediction zeroed
    tgt[2, 0, 0, 2] = 1.0                  # ground truth at the quirk
    for idxs in (None, [3, 1, 0]):
        ref = jeval.accuracy(jnp.asarray(out), jnp.asarray(tgt), idxs=idxs,
                             thr=0.5)
        got = teval.accuracy(_t(out), _t(tgt), idxs=idxs, thr=0.5)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64), rtol=1e-6)
    jp, jm = jeval.get_preds(jnp.asarray(out))
    tp, tm = teval.get_preds(_t(out))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tp[0, 0].tolist() == [float(W), 0.0]
    d = _t(np.array([0.1, -1.0, 0.7, 0.2], np.float32))
    np.testing.assert_allclose(float(teval.dist_acc(d)),
                               float(jeval.dist_acc(jnp.asarray(d.numpy()))))
    assert float(teval.dist_acc(torch.full((3,), -1.0))) == -1.0


# --- render: the plain version is the JAX renderer's arithmetic. Equal
# weights and windows; the values are torch's exp against XLA's: equal at
# sigma = 1 (the flagship's), within 1 ulp of f32 otherwise.

@pytest.mark.parametrize('sigma,hm,img,J', [(1, (16, 16), (64, 64), 16),
                                            (2, (64, 64), (256, 256), 16),
                                            (1, (12, 20), (48, 80), 16),
                                            (1, (12, 20), (48, 80), 17),
                                            (2, (13, 20), (52, 80), 17)],
                         ids=['1-hm0-img0', '2-hm1-img1', '1-hm2-img2', 'J17-12x20',
                              'J17-13x20-WJ-odd'])
def test_render_plain_matches_jax_and_pallas_exactly(rng, sigma, hm, img, J):
    """J = 17 (COCO) too, and a 13-wide map at J = 17: W * J = 221, so the
    kernel's rows do not start on 16 bytes. The J = 17 cases draw from
    their own stream, so the module `rng`'s draws that later tests in
    this file take do not depend on them."""
    B = 4
    if J != 16:
        rng = np.random.RandomState(J * 100 + hm[0])
    joints = rng.uniform(-0.3 * img[0], 1.3 * img[0], size=(B, J, 2)).astype(np.float32)
    joints[0, :4] = [[0, 0], [img[0] - 1, img[1] - 1], [-2, 5], [img[0] + 3, 7]]
    vis = (rng.uniform(size=(B, J)) > 0.2).astype(np.float32)
    kw = dict(heatmap_size=hm, image_size=img, sigma=sigma)
    t, w = render_gaussian_targets(_t(joints), _t(vis), **kw)
    jt, jw = jax_render(joints, vis, **kw)
    pt, pw = render_gaussian_targets_pallas(joints, vis, interpret=True, **kw)
    assert t.shape == (B, hm[1], hm[0], J) and t.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(w.numpy(), np.asarray(pw))
    for ref in (np.asarray(jt), np.asarray(pt)):
        np.testing.assert_array_equal(t.numpy() > 0, ref > 0)
        if sigma == 1:
            np.testing.assert_array_equal(t.numpy(), ref)
        np.testing.assert_array_max_ulp(t.numpy(), ref, maxulp=1)
    assert (t.numpy() > 0).any() and (w.numpy() == 0).any()


# --- max-pool: forward vs the Pallas kernel, backward vs jax.grad of it

def _pool_input(rng, H, W, C, dtype=np.float32):
    """Random values with planted 2-, 3- and 4-way ties of the window max."""
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    x[0, 0:2, 0:2, 0] = 3.0                        # 4 equal
    x[0, 2:4, 2:4, 1] = [[2.0, 2.0], [2.0, -1.0]]  # 3 equal
    x[1, 0:2, 2:4, 2] = [[1.5, -4.0], [1.5, 0.0]]  # 2 equal
    x[1, 2:4, 0:2, 3] = [[-5.0, -5.0], [-6.0, -5.0]]
    return x.astype(dtype)


@pytest.mark.parametrize('H,W,C', [(8, 8, 16), (24, 24, 32), (12, 20, 8)])
def test_maxpool_plain_matches_pallas(rng, H, W, C):
    x = _pool_input(rng, H, W, C)
    g = rng.normal(size=(2, H // 2, W // 2, C)).astype(np.float32)
    ref = maxpool2x2_pallas(jnp.asarray(x), True)
    _, vjp = jax.vjp(lambda a: maxpool2x2_pallas(a, True), jnp.asarray(x))
    ref_dx, = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    out = maxpool2x2(xt, ties='split')
    out.backward(_t(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_dx))
    # ties split the window's gradient: 4-way -> g/4 each, 3-way -> g/3
    np.testing.assert_allclose(xt.grad[0, 0:2, 0:2, 0].numpy(), g[0, 0, 0, 0] / 4)
    np.testing.assert_allclose(xt.grad[0, 2, 2:4, 1].numpy(), g[0, 1, 1, 1] / 3)
    assert float(xt.grad[0, 3, 3, 1]) == 0.0


def test_maxpool_bf16_backward_matches_pallas(rng):
    x = _pool_input(rng, 8, 8, 16)
    g = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: maxpool2x2_pallas(a, True), xb)
    ref, = vjp(gb)
    xt = _t(x).to(torch.bfloat16).requires_grad_(True)
    maxpool2x2(xt, ties='split').backward(_t(g).to(torch.bfloat16))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
def test_model_pool_gradient_matches_jax_max_pool(dtype):
    """The model's pool with the kernel switch on (`max_pool(x, kernel=True)`)
    gives a tie's whole gradient to the first maximum, as `jax.grad` of the
    JAX model's `nn.max_pool` does: equal, on maps with planted 2-, 3- and
    4-way ties (4-way also across a whole row of channels). Its own seeded
    stream: the file's `rng` feeds the tests after it."""
    rng = np.random.RandomState(6)
    x = _pool_input(rng, 8, 12, 16)
    x[0, 4:6, 4:6, :] = 1.0
    x[1, 6:8, 0:2, 5] = [[0.5, -2.0], [0.5, 0.5]]
    g = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    xj, gj = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    _, vjp = jax.vjp(lambda a: nn.max_pool(a, (2, 2), strides=(2, 2)), xj)
    ref, = vjp(gj)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    xt = _t(np.asarray(xj, np.float32)).to(tdt).permute(0, 3, 1, 2).requires_grad_(True)
    out = max_pool(xt.contiguous(memory_format=torch.channels_last), kernel=True)
    out.backward(_t(np.asarray(gj, np.float32)).to(tdt).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(ref, np.float32))
    # the 4-way tie: all of g at the window's top-left element
    assert float(xt.grad[0, 0, 0, 0]) == float(np.asarray(gj, np.float32)[0, 0, 0, 0])
    assert not xt.grad[0, 0, 0:2, 0:2].flatten()[1:].any()
    # the plain version of the first-maximum kernel is F.max_pool2d's backward
    xp = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    torch.nn.functional.max_pool2d(xp, 2, 2).backward(_t(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        maxpool2x2_bwd_first_reference(_t(x), _t(g)).numpy(),
        xp.grad.permute(0, 2, 3, 1).numpy())


# --- upsample backward vs the VJP of the Pallas kernel

@pytest.mark.parametrize('H,W,C', [(8, 8, 32), (12, 12, 32), (3, 5, 8)])
def test_upsample_backward_matches_pallas_vjp(rng, H, W, C):
    low = rng.normal(size=(2, H, W, C)).astype(np.float32)
    skip = rng.normal(size=(2, 2 * H, 2 * W, C)).astype(np.float32)
    g = rng.normal(size=(2, 2 * H, 2 * W, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: upsample2x_add_pallas(a, b, True),
                     jnp.asarray(low), jnp.asarray(skip))
    rl, rs = vjp(jnp.asarray(g))
    lt, st = _t(low).requires_grad_(True), _t(skip).requires_grad_(True)
    upsample2x_add(lt, st).backward(_t(g))
    # f32: four addends, one order vs another; skip's gradient is g
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(rl), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st.grad.numpy(), np.asarray(rs))


def test_upsample_backward_bf16_within_one_ulp_of_pallas(rng):
    """The port sums the four bf16 taps in f32 and rounds once; the Pallas
    kernel sums in bf16. They may differ by one bf16 ulp of the result."""
    g = rng.normal(size=(2, 16, 24, 64)).astype(np.float32)
    gb = jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: upsample2x_add_pallas(a, b, True),
                     jnp.zeros((2, 8, 12, 64), jnp.bfloat16),
                     jnp.zeros((2, 16, 24, 64), jnp.bfloat16))
    ref = np.asarray(vjp(gb)[0], np.float32)
    lt = torch.zeros(2, 8, 12, 64, dtype=torch.bfloat16, requires_grad=True)
    st = torch.zeros(2, 16, 24, 64, dtype=torch.bfloat16, requires_grad=True)
    upsample2x_add(lt, st).backward(_t(g).to(torch.bfloat16))
    got = lt.grad.float().numpy()
    ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16   # bf16 ulp
    assert (np.abs(got - ref) <= ulp).all()


# --- fused bottleneck: autograd Function vs the JAX custom VJP

def _port_params(p, requires_grad=False):
    return BottleneckParams(*[_t(np.asarray(v)).requires_grad_(requires_grad)
                              for v in p])


def test_bottleneck_backward_matches_jax(rng):
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    params = jbneck.random_params(jax.random.PRNGKey(3), 32, 16,
                                  dtype=jnp.float32, scale=0.3)
    jdx, jdp = jbneck.bottleneck_backward_reference(jnp.asarray(x), params,
                                                    jnp.asarray(g))
    dx, dp = bottleneck_backward_reference(_t(x), _port_params(params), _t(g))
    # f32 products summed in another order over cancelling terms: the JAX
    # package holds this backward to its own VJP at the same tolerance
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **tol)
    for name, a, b in zip(BottleneckParams._fields, dp, jdp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)

    # through the autograd Function vs jax.grad of the custom VJP
    loss = lambda xx, pp: jnp.sum(jnp.sin(jbneck.fused_bottleneck(xx, pp, True)))
    jgx, jgp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    xt = _t(x).requires_grad_(True)
    pt = _port_params(params, requires_grad=True)
    before = fused_bottleneck.backward_calls
    torch.sin(fused_bottleneck(xt, pt)).sum().backward()
    assert fused_bottleneck.backward_calls == before + 1
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **tol)
    for name, a, b in zip(BottleneckParams._fields, pt, jgp):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=name, **tol)


def test_bottleneck_backward_bf16_matches_jax(rng):
    """bf16 operands, f32 accumulation: the rounding points agree with the
    JAX backward, so the gradients agree to f32 summation noise."""
    x = (0.5 * rng.normal(size=(2, 8, 8, 32))).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    params = jbneck.random_params(jax.random.PRNGKey(1), 32, 16)
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    jdx, jdp = jbneck.bottleneck_backward_reference(xb, params, gb)
    tp = BottleneckParams(*[_t(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for v in params])
    dx, dp = bottleneck_backward_reference(_t(x).to(torch.bfloat16), tp,
                                           _t(g).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dp.w2.dtype == torch.bfloat16
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(dx.float().numpy(), np.asarray(jdx, np.float32)) < 1e-2
    for name, a, b in zip(BottleneckParams._fields, dp, jdp):
        assert rel(a.float().numpy(), np.asarray(b, np.float32)) < 1e-2, name
