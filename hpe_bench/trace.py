"""The traced part of a `--trace 1` run: a `torch.profiler` window over a
few steps or batches, reduced to what the per-layer metrics read.

  * busy time: the union of the intervals in which a kernel ran on the
    card (overlapping streams counted once), and the window's length;
  * kernels by name, and the longest idle gaps labelled by what the host
    was doing (the innermost CPU op or range open at the gap's middle);
  * each launch of a port kernel with its op's input shapes: the kernel's
    `linked_correlation_id` is the launching op's correlation id, so every
    launch is paired with the `hpe::` op that made it.

Timestamps are the profiler's, nanoseconds of the wall clock
(`time.time_ns()` reads the same clock).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

# idle gaps labelled one by one (the longest); the rest are summed
LABELLED_GAPS = 500


class Window:
    """`with Window(device, ops) as w:` profiles the block (the card
    synchronised at both ends); `w.summary` is then its reduction. Without
    `ops` only the card's activity (kernels, copies, runtime calls) is
    recorded, which leaves the host's pace as it is: busy and idle time are
    read so. With `ops` every thread's operators and their input shapes are
    recorded too, which slows the host several fold: the port kernels'
    launches are paired with their shapes so, and their device times do not
    change."""

    def __init__(self, device, ops: bool = False):
        self.device, self.ops = torch.device(device), ops
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if self.ops or self.device.type != 'cuda' else []
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        # every thread's ops (the batcher's worker, DDP's), not only this one's
        self._prof = profile(activities=acts, record_shapes=self.ops,
                             experimental_config=torch._C._profiler._ExperimentalConfig(
                                 profile_all_threads=self.ops))
        self._prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.t1_ns = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce(self._prof.profiler.kineto_results.events(),
                                  self.t0_ns, self.t1_ns, self.device)
        return False


def _is_device(e) -> bool:
    return str(e.device_type()).endswith('CUDA')


def union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered_ns(merged, lo: int, hi: int) -> int:
    """Length of [lo, hi) that the merged intervals cover."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


def reduce(events, t0_ns: int, t1_ns: int, device) -> dict:
    idx = device.index if device.type == 'cuda' and device.index is not None else 0
    kernels, cpu = [], []
    for e in events:
        if _is_device(e):
            # a range's device-side copy (record_function) is no operation
            if (e.device_index() == idx and e.duration_ns() > 0
                    and not e.is_user_annotation()):
                kernels.append(e)
        else:
            cpu.append(e)
    merged = union([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in kernels])
    lo = min([t0_ns] + [s for s, _ in merged[:1]])
    hi = max([t1_ns] + [e for _, e in merged[-1:]])
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name()] += e.duration_ns() * 1e-9
    ops = {e.correlation_id(): e for e in cpu if e.name().startswith('hpe::')}
    port = []
    for e in kernels:
        op = ops.get(e.linked_correlation_id())
        if op is not None:
            port.append({'op': op.name(), 'shapes': op.shapes(), 'kernel': e.name(),
                         'seconds': e.duration_ns() * 1e-9})
    # what the host did in each idle gap: the innermost CPU event open at
    # its middle (runtime calls included: a gap inside cudaStreamSynchronize
    # is the host waiting), else the dispatch of the kernel that ends it
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in cpu
                    if e.duration_ns() > 0), key=lambda s: s[0])
    gaps, prev = [], lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    kstart = sorted((e.start_ns(), e.name()) for e in kernels)
    ks = [k[0] for k in kstart]
    idle = defaultdict(float)
    starts = [s[0] for s in spans]
    gaps.sort(key=lambda g: g[0] - g[1])
    for g0, g1 in gaps[LABELLED_GAPS:]:
        idle[f'gaps shorter than the {LABELLED_GAPS} longest'] += (g1 - g0) * 1e-9
    for g0, g1 in gaps[:LABELLED_GAPS]:
        mid = (g0 + g1) // 2
        k = bisect.bisect_right(starts, mid)
        label, best = None, None
        for s, e, name in spans[max(0, k - 4000):k]:
            if e > mid and (best is None or e - s < best):
                label, best = name, e - s
        if label is None:
            j = bisect.bisect_left(ks, g1)
            label = ('host dispatch before ' + kstart[j][1][:120] if j < len(kstart)
                     else 'host after the last kernel')
        idle[label] += (g1 - g0) * 1e-9
    return {
        'window_s': (hi - lo) * 1e-9, 'busy_s': covered_ns(merged, lo, hi) * 1e-9,
        'merged': merged, 'lo': lo, 'hi': hi,
        'kernel_s': dict(by_name), 'port': port,
        'idle_by_host': dict(idle),
    }


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each as [[name, seconds], ...]."""
    ops = sorted(summary['kernel_s'].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary['idle_by_host'].items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[n[:200], s] for n, s in ops],
            'idle_gaps': [[n[:200], s] for n, s in gaps]}
