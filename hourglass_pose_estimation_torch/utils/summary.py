"""Model summaries and profiling helpers.

Port of `hourglass_pose_estimation_tpu/utils/summary.py`: `count_params`
and `summarize` (the JAX package tabulates a flax module; here a table of
the top-level submodules), `profile_step` (one call under the profiler,
written as a Chrome trace) and `step_cost` (the operations of one call).
"""

from __future__ import annotations

import os

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

import hourglass_pose_estimation_torch.ops.hopper  # noqa: F401  (registers the hpe ops)


def count_params(model: nn.Module) -> int:
    """Number of parameter elements of `model` (buffers excluded)."""
    return sum(p.numel() for p in model.parameters())


def summarize(model: nn.Module) -> str:
    """One line per top-level submodule: name, class and parameters, then
    the total."""
    rows = [f'{name:<14} {type(m).__name__:<16} {count_params(m):>12,}'
            for name, m in model.named_children()]
    return '\n'.join(rows + [f'{"total":<31} {count_params(model):>12,}'])


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_step(fn, *args, trace_dir: str) -> str:
    """Run fn(*args) once outside the trace (kernel builds, warm-up), then
    once under `torch.profiler` (CPU activity, and CUDA where a card is
    there), and write the Chrome trace `trace.json` under `trace_dir`
    (Perfetto or chrome://tracing open it). Returns trace_dir."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    _sync()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn(*args)
        _sync()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, 'trace.json'))
    return trace_dir


@register_flop_formula([torch.ops.hpe.fused_bottleneck_chunked,
                        torch.ops.hpe.fused_bottleneck_image])
def _bottleneck_flops(x_shape, a1, b1, w1_shape, *rest, **kwargs) -> int:
    """The fused bottleneck's three products: 1x1 C->P, 3x3 P->P, 1x1 P->C."""
    B, H, W, C = x_shape
    P = w1_shape[1]
    return 2 * B * H * W * (C * P + 9 * P * P + P * C)


def step_cost(fn, *args) -> dict:
    """{'flops': ...}: the operations of one call of fn(*args), counted by
    `torch.utils.flop_counter.FlopCounterMode` (products and convolutions,
    the fused bottleneck's included). Unlike XLA's `cost_analysis` there is
    no estimate of the bytes accessed."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {'flops': counter.get_total_flops()}
