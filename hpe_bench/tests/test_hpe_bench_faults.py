"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a tiny size (f32), with each fault a cell can have planted in the
program: a train step that returns its state unchanged, one that leaves half
of the batch out (the mean taken over the rest). A sound run of the same
cells comes out correct and reports its cell's metrics."""

import contextlib

import pytest
import torch

from conftest import tiny_cell
from hpe_bench import calibrate, harness

CELLS = [w['name'] for w in harness.benchmark_spec()['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_sound_runs_are_correct(cpu_run, name):
    res = cpu_run(tiny_cell(name, compute_dtype='float32'))
    assert res['correct'], (name, res['checks'])
    e2e = {m['name'] for m in harness.metrics_of(name, harness.benchmark_spec(), False)}
    assert set(res['metrics']) == e2e, res['metrics']


@contextlib.contextmanager
def unchanged_state_steps():
    """While open, the program's train step puts every parameter back as
    it found it."""
    from hourglass_pose_estimation_torch import runner
    real = runner.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def unchanged(state, batch, rng):
            saved = [p.detach().clone() for p in state.model.parameters()]
            state, metrics = step(state, batch, rng)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            return state, metrics
        return unchanged
    runner.make_train_step = make
    try:
        yield
    finally:
        runner.make_train_step = real


FAULTS = {'unchanged_state': unchanged_state_steps, 'half_batch': calibrate.half_batch_steps}


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('name', CELLS)
def test_a_broken_train_step_is_not_correct(cpu_run, name, fault):
    with FAULTS[fault]():
        res = cpu_run(tiny_cell(name, compute_dtype='float32'))
    assert not res['correct'], res['checks']
