"""Percentiles over all requests."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of `values`, where a
    failed or refused request is `math.inf`: it counts as missing every
    latency limit, so a tail that reaches it is infinite."""
    xs = sorted(values)
    if not xs:
        raise ValueError('percentile of no values')
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]
