"""Prefill/decode disaggregation (survey dim 2c-ii): DistServe-style
analytic simulator with ShuffleInfer-style predicted-length scheduling and
an explicit KV-transfer cost, plus the per-iteration cost model of the
serving engine's virtual clock.

Port of ``repro.core.serving.disaggregation``: ``CostModel``,
``PoolConfig``, ``simulate_disaggregated``, ``simulate_colocated`` and
``goodput``. Pure arithmetic over numpy, so the port's virtual-clock
TTFT/TPOT/JCT and the simulators' summaries equal the reference's
exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.serving.request import Request, summarize
from repro_torch.roofline.hw import KV_LINK_GBPS


@dataclasses.dataclass
class CostModel:
    """us-per-token costs for one instance (chip group)."""
    prefill_us_per_token: float = 15.0     # compute-bound
    decode_us_per_token: float = 800.0     # memory-bound (one step, whole batch)
    decode_us_per_ctx_token: float = 0.002  # cache-read component per ctx token
    kv_bytes_per_token: int = 0            # transfer size for disaggregation
    transfer_gbps: float = KV_LINK_GBPS    # inter-pool link (GB/s)

    def prefill_time(self, n_tokens: int) -> float:
        return self.prefill_us_per_token * n_tokens * 1e-6

    def decode_step_time(self, batch: int, mean_ctx: float) -> float:
        return (self.decode_us_per_token
                + self.decode_us_per_ctx_token * mean_ctx * batch) * 1e-6

    def transfer_time(self, prompt_tokens: int) -> float:
        if not self.kv_bytes_per_token:
            return 0.0
        return (self.kv_bytes_per_token * prompt_tokens
                / (self.transfer_gbps * 1e9))


@dataclasses.dataclass
class PoolConfig:
    n_prefill: int = 1           # prefill instances
    n_decode: int = 1            # decode instances
    decode_batch: int = 32


def simulate_disaggregated(reqs: List[Request], cost: CostModel,
                           pools: PoolConfig,
                           predict_len: bool = False) -> Dict:
    """Event-driven simulation of a 2-pool deployment.

    Prefill pool: FCFS per instance. KV transfer delays decode entry.
    Decode pool: continuous batching per instance; with ``predict_len``
    (ShuffleInfer) requests go to the decode instance with the least
    predicted remaining work rather than round-robin.
    """
    prefill_free = [0.0] * pools.n_prefill
    decode_load = [0.0] * pools.n_decode          # predicted remaining work
    decode_queues: List[List[Request]] = [[] for _ in range(pools.n_decode)]
    decode_clock = [0.0] * pools.n_decode

    for i, r in enumerate(sorted(reqs, key=lambda r: r.arrival)):
        # --- prefill pool ---------------------------------------------------
        p = int(np.argmin(prefill_free))
        start = max(prefill_free[p], r.arrival)
        pf_done = start + cost.prefill_time(r.prompt_len)
        prefill_free[p] = pf_done
        r.first_token_time = pf_done              # first token from prefill
        ready = pf_done + cost.transfer_time(r.prompt_len)
        # --- decode pool assignment -----------------------------------------
        if predict_len:
            work = r.predicted_len or r.max_new_tokens
            d = int(np.argmin([decode_load[j] for j in range(pools.n_decode)]))
            decode_load[d] += work
        else:
            d = i % pools.n_decode
        decode_queues[d].append(r)
        r._ready = ready                                       # type: ignore

    # run each decode instance: continuous batching, 1 token/step/request
    for d, queue in enumerate(decode_queues):
        t = 0.0
        active: List[Request] = []
        pending = sorted(queue, key=lambda r: r._ready)        # type: ignore
        while pending or active:
            while pending and len(active) < pools.decode_batch \
                    and pending[0]._ready <= t:                # type: ignore
                active.append(pending.pop(0))
            if not active:
                t = pending[0]._ready                          # type: ignore
                continue
            mean_ctx = float(np.mean([r.total_len for r in active]))
            t += cost.decode_step_time(len(active), mean_ctx)
            for r in list(active):
                r.generated.append(0)
                if r.is_finished():
                    r.finish_time = t
                    active.remove(r)
    return summarize(reqs)


def simulate_colocated(reqs: List[Request], cost: CostModel,
                       n_instances: int, decode_batch: int = 32) -> Dict:
    """Baseline: each instance interleaves prefill and decode (prefill
    preempts the decode batch -- the TTFT/TPOT interference DistServe
    removes)."""
    queues: List[List[Request]] = [[] for _ in range(n_instances)]
    for i, r in enumerate(sorted(reqs, key=lambda r: r.arrival)):
        queues[i % n_instances].append(r)

    for inst in queues:
        t = 0.0
        active: List[Request] = []
        pending = list(inst)
        while pending or active:
            # admit: prefill blocks the whole instance (interference)
            while pending and len(active) < decode_batch \
                    and pending[0].arrival <= t:
                r = pending.pop(0)
                t = max(t, r.arrival) + cost.prefill_time(r.prompt_len)
                r.first_token_time = t
                active.append(r)
            if not active:
                if pending:
                    t = max(t, pending[0].arrival)
                    continue
                break
            mean_ctx = float(np.mean([r.total_len for r in active]))
            t += cost.decode_step_time(len(active), mean_ctx)
            for r in list(active):
                r.generated.append(0)
                if r.is_finished():
                    r.finish_time = t
                    active.remove(r)
    return summarize(reqs)


def goodput(reqs: List[Request], ttft_slo: float, tpot_slo: float
            ) -> float:
    """DistServe's metric: fraction of requests meeting BOTH SLOs."""
    done = [r for r in reqs if r.finish_time is not None]
    ok = 0
    for r in done:
        ttft = r.ttft()
        tpot = r.tpot() or 0.0
        if ttft is not None and ttft <= ttft_slo and tpot <= tpot_slo:
            ok += 1
    return ok / max(1, len(done))
