"""The one general traffic generator: every mix is a data file.

A mix (``traffic/<name>.json``) gives its loop kind, its rate or client
count, and a distribution for each length it uses::

    {"loop": "open_poisson", "rate_per_s": 7.5,
     "lengths": {"visual": {"dist": "loguniform", "lo": 1024, "hi": 16000},
                 "text":   {"dist": "uniform",    "lo": 16,   "hi": 256},
                 "output": {"dist": "loguniform", "lo": 16,   "hi": 128}}}

Sizes are stratified quantiles of each distribution, so every seed sends
the same multiset of sizes and only their order (and the pairing of the
lengths) follows ``--seed``: two seeds do the same work, and the spread
of a cell across seeds is the spread of the system, not of the draw. An
open loop draws its ``n`` requests over the whole window and its gaps as
the ``n`` quantiles of the exponential distribution at the mix's rate; a
closed loop deals one round of stratified sizes to its clients at a time.

With ``"block": B`` the order is stratified too: each run of B
consecutive requests (and gaps) holds one value from each B-quantile
stratum, in an order of its own, so that a seed cannot bunch the largest
requests, or the shortest gaps, together.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from harness.weights import TRAFFIC, stream

DIMS = ("visual", "text", "output")


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles ``F^-1((i + 0.5) / n)`` as ints."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        v = lo + u * (hi - lo)
    elif dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def largest(mix: Dict, dim: str) -> int:
    d = mix["lengths"].get(dim)
    return 0 if d is None else int(d["hi"])


def order(values: np.ndarray, block: int,
          rng: np.random.Generator) -> np.ndarray:
    """``values`` (ascending) in an order drawn from ``rng``: a plain
    permutation, or with ``block`` > 1 one value from each of ``block``
    strata in each run of ``block`` (the remainder last)."""
    n = len(values)
    if block <= 1 or n < 2 * block:
        return rng.permutation(values)
    m = n // block
    strata = values[:m * block].reshape(block, m)
    picks = np.stack([row[rng.permutation(m)] for row in strata], 1)
    runs = [rng.permutation(run) for run in picks]
    return np.concatenate(runs + [rng.permutation(values[m * block:])])


def sizes(mix: Dict, n: int, rng: np.random.Generator) -> List[Dict]:
    """``n`` requests' lengths: each dimension's ``n`` quantiles in an
    order of their own drawn from ``rng``."""
    block = int(mix.get("block", 0))
    cols = {}
    for dim in DIMS:
        d = mix["lengths"].get(dim)
        cols[dim] = (order(quantiles(d, n), block, rng) if d is not None
                     else np.zeros(n, np.int64))
    return [{dim: int(cols[dim][i]) for dim in DIMS} for i in range(n)]


def open_schedule(mix: Dict, seed: int, seconds: float) -> List[Dict]:
    """An open loop's requests: ``round(rate * seconds)`` sizes, each with
    its due time (seconds after the window opens)."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(stream(seed, TRAFFIC))
    reqs = sizes(mix, n, rng)
    u = (np.arange(n) + 0.5) / n
    gaps = order(-np.log1p(-u) / rate, int(mix.get("block", 0)), rng)
    # the first request is due a gap after the window opens
    due = np.cumsum(gaps) * (seconds / max(seconds, float(np.sum(gaps))))
    for r, t in zip(reqs, due):
        r["due_s"] = float(t)
    return reqs
