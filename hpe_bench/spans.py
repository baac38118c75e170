"""The program's own train-step spans, read against the traced window.

The program records its spans (`utils/tracing.py` in the port) under any
active torch profiler, so a `--trace 1` run's window records the phases of
each traced step: `train.stage`, `train.forward`, `train.backward`,
`train.optimizer` and `train.metrics` inside `train.step`, each with its
host interval (nanoseconds of the profiler's clock) and its device time
(CUDA events on the stream, idle inside the phase included). Only the
spans whose host interval lies in the first traced window,
[trace['lo'], trace['hi']], are read: the ops window's step comes after it.

Two readings:
  * a phase's mean device ms a step;
  * the card's idle while the host was inside given spans: the part of
    their host intervals that no kernel covers (`trace['merged']`). It
    holds whatever the lag between host and card: while no kernel runs the
    card's queue is empty, so the card waits on what the host is doing.

A program without the recorder, or a window with no span, gives None.
"""

from __future__ import annotations

from hpe_bench.trace import covered_ns, union

# the phases whose dispatch keeps the card waiting on the host
DISPATCH = ('train.forward', 'train.backward', 'train.optimizer')


def recorded() -> list:
    """The program's recorded spans ([] where the program has no recorder)."""
    try:
        from hourglass_pose_estimation_torch.utils import tracing
    except ImportError:
        return []
    return tracing.spans()


def in_window(trace, records=None) -> list:
    """The `train.*` spans whose host interval lies in the traced window."""
    if trace is None:
        return []
    records = recorded() if records is None else records
    return [s for s in records if s['name'].startswith('train.')
            and trace['lo'] <= s['start_ns'] and s['end_ns'] <= trace['hi']]


def phase_ms(trace, name: str, records=None):
    """Span `name`'s device ms summed over the window's steps, over their
    number (None without a span that has a device time)."""
    got = [s for s in in_window(trace, records) if s['name'] == name
           and s['device_ms'] is not None]
    if not got:
        return None
    return sum(s['device_ms'] for s in got) / len({s['step'] for s in got})


def idle_inside_ns(trace, names, records=None):
    """Nanoseconds of the window in which no kernel ran while the host was
    inside a span named in `names` (None without such a span)."""
    host = union([(s['start_ns'], s['end_ns']) for s in in_window(trace, records)
                  if s['name'] in names])
    if not host:
        return None
    return sum((e - s) - covered_ns(trace['merged'], s, e) for s, e in host)


def dispatch_idle(trace, records=None):
    """The share (%) of the window with no kernel running while the host was
    inside the dispatch phases (DISPATCH); None where no kernel ran (a run
    off the card)."""
    idle = idle_inside_ns(trace, DISPATCH, records)
    if idle is None or not trace['merged'] or trace['hi'] <= trace['lo']:
        return None
    return 100.0 * idle / (trace['hi'] - trace['lo'])
