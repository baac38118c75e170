"""The fused bottleneck's two schedules (`impl='image'`, `impl='chunked'`)
on the CPU: each against the JAX package's Pallas kernel of the same
schedule in interpret mode and its XLA oracle, at the heights
`tests/test_pallas.py` holds the two JAX schedules to (one and several row
chunks, a prime height); the switch refuses an unknown schedule, and the
autograd Function runs the schedule `DEFAULT_IMPL` names. The kernels
themselves run on the card (`tests/test_torch_port_cuda.py`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hourglass_pose_estimation_tpu.ops.pallas import bottleneck as jbneck

from hourglass_pose_estimation_torch.ops.hopper import BottleneckParams
from hourglass_pose_estimation_torch.ops.hopper import bottleneck as tbneck

torch.set_num_threads(1)

# f32 on both sides; the products are summed in another order (the JAX
# package holds its own two schedules to its oracle at the same 1e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def params():
    p = jbneck.random_params(jax.random.PRNGKey(0), 32, 16, dtype=jnp.float32)
    return p, BottleneckParams(*[torch.from_numpy(np.array(v)) for v in p])


@pytest.mark.parametrize('impl', ['image', 'chunked'])
@pytest.mark.parametrize('H', [16, 17, 24, 32, 64])
def test_both_schedules_match_their_pallas_kernel(params, impl, H):
    jp, tp = params
    x = np.random.RandomState(H).normal(size=(2, H, 16, 32)).astype(np.float32)
    pallas = np.asarray(jbneck.fused_bottleneck_pallas(jnp.asarray(x), jp,
                                                       interpret=True, impl=impl))
    xla = np.asarray(jbneck.bottleneck_reference(jnp.asarray(x), jp))
    got = tbneck.fused_bottleneck(torch.from_numpy(x), tp, impl=impl).numpy()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_unknown_schedule_raises(params):
    x = torch.zeros(1, 16, 16, 32)
    with pytest.raises(ValueError, match="'image' or 'chunked'"):
        tbneck.fused_bottleneck(x, params[1], impl='whole')
    with pytest.raises(ValueError, match="'image' or 'chunked'"):
        jbneck.fused_bottleneck_pallas(jnp.zeros((1, 16, 16, 32)), params[0],
                                       interpret=True, impl='whole')


def test_autograd_function_runs_the_default_schedule(params, monkeypatch):
    """The Function's forward dispatches to the schedule named by the call,
    else to DEFAULT_IMPL as it stands at the call; its backward is the same
    under both."""
    seen = []
    for impl, fn in list(tbneck._FORWARD.items()):
        monkeypatch.setitem(tbneck._FORWARD, impl,
                            lambda x, p, impl=impl, fn=fn: seen.append(impl) or fn(x, p))
    x = torch.from_numpy(np.random.RandomState(0).normal(size=(2, 16, 16, 32))
                         .astype(np.float32)).requires_grad_()
    grads = []
    for default in ('image', 'chunked'):
        monkeypatch.setattr(tbneck, 'DEFAULT_IMPL', default)
        x.grad = None
        tbneck.fused_bottleneck(x, params[1]).sum().backward()
        grads.append(x.grad.clone())
    tbneck.fused_bottleneck(x, params[1], impl='image')
    assert seen == ['image', 'chunked', 'image']
    assert torch.equal(grads[0], grads[1])
