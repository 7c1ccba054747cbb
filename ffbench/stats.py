"""Percentiles as the benchmark reports them."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """Nearest-rank ``q``-th percentile (q in (0, 100]): the smallest value
    with at least ``q`` % of the values at or below it.  A value of ``inf``
    (a request that was never answered) ranks above every answer.  None when
    there are no values."""
    v = sorted(values)
    if not v:
        return None
    k = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return float(v[k])
