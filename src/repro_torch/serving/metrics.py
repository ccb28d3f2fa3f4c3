"""SLO telemetry for the serving layer.

Port of ``repro.serving.metrics`` (same records, same summary).

Per-request latency records against the engine's deterministic virtual
clock, aggregated into the summary a serving operator actually pages on:
TTFT / TPOT percentiles (p50/p95/p99), queue wait, SLO attainment
fractions, abort counts, and the virtual-clock decode cost per decoder
group (``Engine.group_costs`` -- the price each strategy charged the
clock, which is how a mixed speculative/greedy deployment is costed).

``queue_wait`` here is the ADMISSION-gate wait (virtual clock at
``Engine.submit`` minus clock at the client's submit call); scheduler
queueing after admission is already inside TTFT.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.serving.request import Request
from repro_torch.obs.stats import summarize_records


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle metrics (virtual-clock seconds)."""
    rid: int
    decoder: str
    prompt_len: int
    tokens: int                       # generated (partial if aborted)
    queue_wait: float
    ttft: Optional[float]
    tpot: Optional[float]
    jct: Optional[float]
    aborted: bool
    ttft_ok: bool                     # against the request's OWN SLO
    tpot_ok: bool
    # END-TO-END first-token latency: admission-gate queue wait + TTFT.
    # ``Engine.submit`` re-anchors ``arrival`` at the commit clock, so
    # plain ``ttft`` is the ENGINE-phase latency only -- a deferred
    # request's gate wait is invisible to it. e2e_ok judges the TTFT SLO
    # a user actually experiences (what graceful degradation improves
    # over defer-only admission).
    e2e_ttft: Optional[float] = None
    e2e_ok: bool = False


class MetricsRegistry:
    """Collects ``RequestRecord``s and summarizes them.

    One registry per server by default; pass a shared instance to
    ``LVLM.serve_async(metrics=...)`` to aggregate across servers.
    """

    #: Default cold-start TTFT estimate (seconds). Before any request
    #: finishes there is no TTFT history, and returning 0.0 made EDF
    #: ``order="slack"`` maximally optimistic for the whole first wave --
    #: every waiter looked like it had a full SLO of slack, so the first
    #: drain order ignored imminent deadlines entirely. A small positive
    #: prior (half a typical TTFT SLO) keeps cold-start ordering sane and
    #: washes out as soon as real records arrive.
    DEFAULT_TTFT_PRIOR = 0.25

    def __init__(self, ttft_prior: float = DEFAULT_TTFT_PRIOR):
        self.records: List[RequestRecord] = []
        self.ttft_prior = float(ttft_prior)
        self._expected_ttft: Optional[float] = None   # cache, see below

    def observe(self, req: Request, *, queue_wait: float = 0.0,
                decoder: str = "", aborted: bool = False) -> RequestRecord:
        rec = RequestRecord(
            rid=req.rid, decoder=decoder or (req.decoder or "default"),
            prompt_len=req.prompt_len, tokens=len(req.generated),
            queue_wait=queue_wait, ttft=req.ttft(), tpot=req.tpot(),
            jct=req.jct(), aborted=aborted,
            ttft_ok=(not aborted and req.ttft() is not None
                     and req.ttft() <= req.slo.ttft_ms * 1e-3),
            tpot_ok=(not aborted
                     and (req.tpot() or 0.0) <= req.slo.tpot_ms * 1e-3),
            e2e_ttft=(None if req.ttft() is None
                      else queue_wait + req.ttft()),
            e2e_ok=(not aborted and req.ttft() is not None
                    and queue_wait + req.ttft()
                    <= req.slo.ttft_ms * 1e-3))
        self.records.append(rec)
        self._expected_ttft = None        # new record invalidates the cache
        return rec

    def expected_ttft(self) -> float:
        """Live TTFT estimate (median of finished requests; ``ttft_prior``
        before any finish). This is what SLO-slack dispatch subtracts from
        a waiter's deadline: slack = deadline - now - expected_ttft.
        Cached per new record: the slack key evaluates it per waiter per
        drain, which must not rescan the whole history each time."""
        if self._expected_ttft is None:
            ttfts = [r.ttft for r in self.records
                     if not r.aborted and r.ttft is not None]
            self._expected_ttft = (float(np.median(ttfts)) if ttfts
                                   else self.ttft_prior)
        return self._expected_ttft

    # ---------------------------------------------------------- summary --
    def summary(self, engine=None) -> Dict:
        # the aggregate body lives in repro_torch.obs.stats (the fleet-
        # merged summary of slice 6 will share it, so the two cannot drift)
        out = summarize_records(self.records)
        if engine is not None:
            out["virtual_time_s"] = engine.clock
            out["decode_cost_by_group"] = dict(engine.group_costs)
        return out
