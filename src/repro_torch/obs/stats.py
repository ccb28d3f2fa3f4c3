"""Shared summary statistics for request-record collections.

Port of ``repro.obs.stats`` (the port keeps its own copy: it imports
no module of ``repro``).

``serving.MetricsRegistry.summary`` and ``cluster.ClusterMetrics``
both reduce lists of ``RequestRecord``-shaped objects to the same
operator-facing aggregate (TTFT/TPOT/JCT means, p50/p95/p99, queue
wait, SLO attainment fractions). This module is the single
implementation both delegate to, so the fleet-merged summary and the
single-server summary can never drift.

A "record" here is anything with the ``RequestRecord`` attributes
(``ttft``/``tpot``/``jct``/``queue_wait``/``tokens``/``aborted``/
``ttft_ok``/``tpot_ok``) -- duck-typed so the cluster layer can feed
merged records without re-wrapping.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


def mean_or_none(vals: Sequence[float]) -> Optional[float]:
    return float(np.mean(vals)) if len(vals) else None


def percentile_summary(vals: Sequence[float], prefix: str,
                       ps: Sequence[int] = (50, 95, 99)) -> Dict:
    """``{f"{prefix}_p{p}": value}`` for each requested percentile
    (None when empty) -- same contract as
    ``core.serving.request.percentiles``."""
    out: Dict = {}
    for p in ps:
        key = f"{prefix}_p{p}"
        out[key] = float(np.percentile(vals, p)) if len(vals) else None
    return out


def summarize_records(records: Iterable) -> Dict:
    """The shared summary body: latency means + percentiles + SLO
    attainment over a record collection (see module docstring for the
    record duck type). Engine extras (virtual time, per-group decode
    cost) are layered on by the callers that have an engine."""
    records = list(records)
    done: List = [r for r in records if not r.aborted]
    ttfts = [r.ttft for r in done if r.ttft is not None]
    tpots = [r.tpot for r in done if r.tpot is not None]
    jcts = [r.jct for r in done if r.jct is not None]
    waits = [r.queue_wait for r in records]
    n = len(done)
    out: Dict = {
        "finished": n,
        "aborted": sum(r.aborted for r in records),
        "tokens": sum(r.tokens for r in done),
        "ttft_mean": mean_or_none(ttfts),
        "tpot_mean": mean_or_none(tpots),
        "jct_mean": mean_or_none(jcts),
        "queue_wait_mean": mean_or_none(waits),
    }
    out.update(percentile_summary(ttfts, "ttft"))
    out.update(percentile_summary(tpots, "tpot"))
    out.update(percentile_summary(waits, "queue_wait"))
    out["slo_ttft_attainment"] = (
        sum(r.ttft_ok for r in done) / n if n else None)
    out["slo_tpot_attainment"] = (
        sum(r.tpot_ok for r in done) / n if n else None)
    out["slo_goodput"] = (
        sum(r.ttft_ok and r.tpot_ok for r in done) / n if n else None)
    # END-TO-END TTFT (admission queue wait + engine TTFT) against the
    # same SLO: the user-perceived attainment that defer-only admission
    # hides in queue_wait. Duck-typed fallback: records without the e2e
    # fields (older producers) fall back to the engine-phase verdict.
    e2es = [r.e2e_ttft for r in done
            if getattr(r, "e2e_ttft", None) is not None]
    if e2es:
        out.update(percentile_summary(e2es, "e2e_ttft"))
    out["slo_e2e_attainment"] = (
        sum(getattr(r, "e2e_ok", r.ttft_ok) for r in done) / n
        if n else None)
    out["slo_e2e_goodput"] = (
        sum(getattr(r, "e2e_ok", r.ttft_ok) and r.tpot_ok
            for r in done) / n if n else None)
    return out
