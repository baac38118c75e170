"""Model summaries.

Port of `count_params` and `summarize` of `hourglass_pose_estimation_tpu/
utils/summary.py` (which tabulates a flax module): the parameter count of
a model, and a table of its top-level submodules with theirs.
"""

from __future__ import annotations

from torch import nn


def count_params(model: nn.Module) -> int:
    """Number of parameter elements of `model` (buffers excluded)."""
    return sum(p.numel() for p in model.parameters())


def summarize(model: nn.Module) -> str:
    """One line per top-level submodule: name, class and parameters, then
    the total."""
    rows = [f'{name:<14} {type(m).__name__:<16} {count_params(m):>12,}'
            for name, m in model.named_children()]
    return '\n'.join(rows + [f'{"total":<31} {count_params(model):>12,}'])
