"""The readers of the program's train-step spans (`spans.py` and the five
`metrics/train.*` readers over it) on a synthetic traced window: kernel
intervals and spans whose device ms and idle are worked out by hand."""

import sys

import pytest

from hpe_bench import harness, spans

# the first traced window: kernels ran in [0, 3000), [4000, 9000) and
# [12000, 19000) ns
TRACE = {'lo': 0, 'hi': 20_000, 'merged': [[0, 3000], [4000, 9000], [12000, 19000]]}


def _span(name, step, start, end, device_ms, parent=None):
    return {'name': name, 'id': 0, 'parent': parent, 'step': step, 'start_ns': start,
            'end_ns': end, 'device_ms': device_ms}


RECORDS = [
    _span('train.step', 0, 0, 11_000, 10.0),
    _span('train.stage', 0, 0, 1000, 1.0),
    _span('train.forward', 0, 1000, 5000, 3.0),      # idle [3000, 4000)
    _span('train.backward', 0, 5000, 10_000, 4.0),   # idle [9000, 10000)
    _span('train.optimizer', 0, 10_000, 10_500, 0.5),  # idle, all 500
    _span('train.metrics', 0, 10_500, 11_000, 0.25),
    _span('train.step', 1, 11_000, 20_000, 9.0),
    _span('train.stage', 1, 11_000, 12_000, 2.0),
    _span('train.forward', 1, 12_000, 15_000, 5.0),    # covered
    _span('train.backward', 1, 15_000, 19_500, 6.0),   # idle [19000, 19500)
    _span('train.optimizer', 1, 19_500, 19_800, 1.5),  # idle, all 300
    _span('train.metrics', 1, 19_800, 20_000, 0.75),
    _span('tp.collective', 1, 12_000, 13_000, None),
    # outside the window (the ops window's step, and one across its end)
    _span('train.forward', 2, 25_000, 26_000, 100.0),
    _span('train.optimizer', 2, 19_900, 21_000, 100.0),
]
# (metric, value read from RECORDS)
WANT = [('train.stage_ms.hg8', 1.5), ('train.forward_ms.hg8', 4.0),
        ('train.backward_ms.mspn2', 5.0), ('train.optimizer_ms.mspn2', 1.0),
        ('train.dispatch_idle.hg8', 100.0 * (1000 + 1000 + 500 + 500 + 300) / 20_000)]
READERS = ['train.stage_ms', 'train.forward_ms', 'train.backward_ms', 'train.optimizer_ms',
           'train.dispatch_idle']
CTX = {'kind': 'train'}


def test_in_window_keeps_the_train_spans_inside_lo_hi():
    got = spans.in_window(TRACE, RECORDS)
    assert len(got) == 12 and all(s['step'] in (0, 1) for s in got)
    assert spans.in_window(None, RECORDS) == []


def test_phase_ms_and_idle_inside_spans():
    assert spans.phase_ms(TRACE, 'train.step', RECORDS) == 9.5
    assert spans.phase_ms(TRACE, 'train.metrics', RECORDS) == 0.5
    assert spans.idle_inside_ns(TRACE, ('train.forward',), RECORDS) == 1000
    # step 1's stage: [11000, 12000) with no kernel
    assert spans.idle_inside_ns(TRACE, ('train.stage',), RECORDS) == 1000
    assert spans.idle_inside_ns(TRACE, ('train.nothing',), RECORDS) is None
    # a span without a device time is left out of its phase
    assert spans.phase_ms(TRACE, 'train.stage', RECORDS + [
        _span('train.stage', 1, 11_000, 12_000, None)]) == 1.5


@pytest.mark.parametrize('metric, value', WANT)
def test_readers_on_a_synthetic_window(monkeypatch, metric, value):
    monkeypatch.setattr(spans, 'recorded', lambda: RECORDS)
    got = harness.metric_reader(metric).read(CTX, TRACE)
    assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize('name', READERS)
def test_readers_give_nothing_without_spans(monkeypatch, name):
    reader = harness.metric_reader(name)
    monkeypatch.setattr(spans, 'recorded', lambda: [])
    assert reader.read(CTX, TRACE) is None
    monkeypatch.setattr(spans, 'recorded', lambda: RECORDS)
    assert reader.read(CTX, None) is None
    assert reader.read({'kind': 'serve'}, TRACE) is None
    # a window off the card (no kernel): no device time, no idle share
    off = dict(TRACE, merged=[])
    cpu = [dict(s, device_ms=None) for s in RECORDS]
    monkeypatch.setattr(spans, 'recorded', lambda: cpu)
    assert reader.read(CTX, off) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, 'hourglass_pose_estimation_torch.utils.tracing', None)
    assert spans.recorded() == []
    assert spans.dispatch_idle(TRACE) is None and spans.phase_ms(TRACE, 'train.stage') is None
