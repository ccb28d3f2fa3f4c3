"""Percentiles over all samples, and the spread of repeated runs.

``percentile`` is a frozen copy of ``repro_torch.obs.stats``'s rule
(``np.percentile`` over every value, linear interpolation), with one
change of purpose: a request that failed enters as ``+inf``, so a
percentile that reaches the failures reads ``inf``.
"""
from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence

import numpy as np


def percentile(vals: Sequence[float], p: float) -> Optional[float]:
    """The ``p``-th percentile of every value (None when there are none);
    ``inf`` values (failed requests) sort last."""
    if not len(vals):
        return None
    arr = np.asarray(vals, np.float64)
    if np.isinf(arr).any():
        # np.percentile interpolates inf - inf to nan: rank by hand
        arr = np.sort(arr)
        pos = (len(arr) - 1) * p / 100.0
        lo, hi = math.floor(pos), math.ceil(pos)
        if math.isinf(arr[hi]):
            return math.inf
        return float(arr[lo] + (arr[hi] - arr[lo]) * (pos - lo))
    return float(np.percentile(arr, p))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, Python's ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else math.inf
