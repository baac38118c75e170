"""One in-program recorder of spans and counters.

    from hourglass_pose_estimation_torch.utils import tracing
    with tracing.span('train.forward'):
        ...
    tracing.count('launches.upsample2x_add')

A span records its name, its id, the id of the span open around it on the
same thread (its parent), a step index (given, or its parent's), its host
start and end in nanoseconds of `time.time_ns()` (the clock of
`torch.profiler`'s events), and, on a CUDA device (given, or its
parent's), a pair of `torch.cuda.Event`s recorded on the current stream at
entry and at exit. The events' elapsed time is the span's device time:
from the stream reaching the span to the stream finishing the span's last
work, idle inside it included. It is resolved when `spans()` is read, for
the spans whose events the card has passed; the hot path never waits for
the card.

Spans are recorded while `enable()` is in force or while a torch profiler
session is active (on this thread, or on all threads: the profiler's
Python flag), so every profile of the program gets them; under an active
profiler a span also opens `record_function(name)`, so the phases show as
ranges in the profiler's own trace. Otherwise `span()` returns a
shared null context: nothing is allocated and no event is recorded. The
last MAX_SPANS spans are kept. Counters always count (an integer add).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

# spans kept: a long profile keeps its last ones
MAX_SPANS = 100_000

_enabled = False
_spans = collections.deque(maxlen=MAX_SPANS)
_counters: dict = {}
_count_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    # the Python flag covers a session that records all threads, which
    # leaves this thread's state unset
    return (torch.autograd.profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled())


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only under an active profiler again."""
    global _enabled
    _enabled = False


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """{name: count} of every counter since the last `reset()`."""
    with _count_lock:
        return dict(_counters)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _count_lock:
        _counters.clear()
    _spans.clear()


class _Span:
    __slots__ = ('name', 'id', 'parent', 'step', 'device', 'start_ns', 'end_ns', 'events',
                 'device_ms', '_range')

    def __init__(self, name, step, device):
        self.name, self.step, self.device = name, step, device
        self.events = self.device_ms = self._range = None

    def __enter__(self):
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.id, self.parent = next(_ids), parent.id if parent else None
        if parent is not None:
            self.step = parent.step if self.step is None else self.step
            self.device = parent.device if self.device is None else self.device
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        if self.device is not None and torch.device(self.device).type == 'cuda':
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _spans.append(self)
        return False

    def record(self) -> dict:
        if self.events is not None and self.events[1].query():
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None
        return {'name': self.name, 'id': self.id, 'parent': self.parent, 'step': self.step,
                'start_ns': self.start_ns, 'end_ns': self.end_ns, 'device_ms': self.device_ms}


def span(name: str, step: int | None = None, device=None):
    """A context manager that records span `name` (see the module
    docstring) while recording is on, else a shared null context. `step`
    and `device` default to those of the span open around it."""
    if not (_enabled or _profiling()):
        return _NULL
    return _Span(name, step, device)


def spans() -> list:
    """The recorded spans in the order they opened, each a dict: name, id,
    parent, step, start_ns, end_ns, device_ms (None off the card, or while
    the card has not passed its end)."""
    return [s.record() for s in sorted(list(_spans), key=lambda s: s.id)]
