"""The port's recorder of spans and counters (`utils/tracing.py`) and the
train step's phase spans, on the CPU: a 1-stack hourglass at 64^2, batch 2.

Checked: with recording off a step records no span and opens no profiler
range; under a CPU profiler (of this thread or of all) one step records
`train.step` around its five phases, in order and nested, with its step
index, and the profiler holds a range of each name whose edges agree with
the span's on one clock; `enable()` records with no profiler and `reset()`
empties; counters count with recording off; the overlapped step's staging
span; the bound on the spans kept."""

import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hourglass_pose_estimation_torch.data import Synthetic, make_spec
from hourglass_pose_estimation_torch.models import HourglassNet
from hourglass_pose_estimation_torch.runner import train_state as tts
from hourglass_pose_estimation_torch.utils import tracing

torch.set_num_threads(1)

PHASES = ['train.stage', 'train.forward', 'train.backward', 'train.optimizer', 'train.metrics']
# a span's edges against its profiler range's, on a CPU: 5-70 us, the
# first range up to ~1.4 ms (its set-up); loose for a loaded test machine
EDGE_NS = 50_000_000
MEDIAN_EDGE_NS = 5_000_000


@pytest.fixture
def recorder():
    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope='module')
def setup():
    ds = Synthetic(True, num_samples=2, inp_res=64, out_res=16, sigma=1,
                   scale_factor=0.25, rot_factor=30)
    return ds.canvas_batch(range(2), canvas=64), make_spec(ds)


def _state():
    torch.manual_seed(0)
    model = HourglassNet(num_stacks=1, num_blocks=1, num_classes=16)
    return tts.init_state(model, tts.make_optimizer(2.5e-3, [], 0.1, 4))


def test_off_records_no_span_and_opens_no_range(recorder, setup, monkeypatch):
    raw, spec = setup

    def no_range(name):
        raise AssertionError(f'a profiler range {name!r} was opened')
    monkeypatch.setattr(torch.profiler, 'record_function', no_range)
    state = _state()
    tts.make_train_step(spec)(state, raw, 0)
    assert tracing.spans() == []
    assert tracing.span('train.step') is tracing.span('train.forward')


@pytest.mark.parametrize('all_threads', [False, True])
def test_profiled_step_records_the_phases_on_the_profilers_clock(recorder, setup, all_threads):
    """Under a profiler of this thread, and of all threads (which leaves
    this thread's profiler state unset)."""
    raw, spec = setup
    state = _state()
    step = tts.make_train_step(spec)
    state, _ = step(state, raw, 0)
    assert tracing.spans() == []
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=all_threads)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        state, _ = step(state, raw, 0)
    got = tracing.spans()
    assert [s['name'] for s in got] == ['train.step'] + PHASES
    root, phases = got[0], got[1:]
    assert root['parent'] is None and root['step'] == 1
    assert all(s['parent'] == root['id'] and s['step'] == 1 for s in phases)
    assert all(s['device_ms'] is None for s in got)
    assert root['start_ns'] <= phases[0]['start_ns'] and phases[-1]['end_ns'] <= root['end_ns']
    for a, b in zip(phases, phases[1:]):
        assert a['start_ns'] <= a['end_ns'] <= b['start_ns'] <= b['end_ns']
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ['train.step'] + PHASES and e.is_user_annotation():
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert sorted(ranges) == sorted(['train.step'] + PHASES)
    assert all(len(v) == 1 for v in ranges.values())
    offsets = []
    for s in got:
        (r0, r1), = ranges[s['name']]
        offsets += [abs(s['start_ns'] - r0), abs(s['end_ns'] - r1)]
    assert max(offsets) < EDGE_NS, offsets
    assert statistics.median(offsets) < MEDIAN_EDGE_NS, offsets


def test_enable_records_without_a_profiler_and_reset_empties(recorder, setup):
    raw, spec = setup
    state = _state()
    recorder.enable()
    tts.make_train_step(spec)(state, raw, 0)
    assert [s['name'] for s in tracing.spans()] == ['train.step'] + PHASES
    tracing.reset()
    assert tracing.spans() == [] and tracing.counters() == {}
    recorder.disable()
    with tracing.span('x'):
        pass
    assert tracing.spans() == []


def test_counters_count_with_recording_off(recorder):
    tracing.count('a')
    tracing.count('a', 4)
    tracing.count('b', 0)
    assert tracing.counters() == {'a': 5, 'b': 0}
    assert tracing.spans() == []


def test_overlapped_step_records_its_staging(recorder, setup):
    raw, spec = setup
    state = _state()
    staged = tts.make_stage_fn(spec, device='cpu')(raw, 0, 0)
    recorder.enable()
    state, _, _ = tts.make_overlapped_train_step(spec)(state, staged, raw, 0)
    got = tracing.spans()
    # the next batch's staging (for step 1), then step 0 with its own phases
    assert [s['name'] for s in got] == ['train.stage', 'train.step'] + PHASES
    assert got[0]['parent'] is None and got[0]['step'] == 1
    assert got[1]['step'] == 0 and got[0]['end_ns'] <= got[1]['start_ns']


def test_spans_kept_are_bounded(recorder):
    recorder.enable()
    for _ in range(tracing.MAX_SPANS + 3):
        with tracing.span('x'):
            pass
    got = tracing.spans()
    # the last ones
    assert len(got) == tracing.MAX_SPANS
    assert got[-1]['id'] - got[0]['id'] == tracing.MAX_SPANS - 1
