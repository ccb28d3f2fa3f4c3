"""``ClusterMetrics``: the fleet-wide view over per-replica registries.

Port of ``repro.cluster.metrics`` (same summary, same
``disaggregation`` block).

Each ``AsyncLVLMServer`` keeps its own ``MetricsRegistry``; the cluster
view MERGES the raw per-request records (not the per-replica summaries --
percentiles do not average) and recomputes TTFT/TPOT/queue-wait
percentiles, SLO attainment, and goodput over the whole fleet. On top it
reports what only the router can see: dispatch and completion counts per
replica, failovers, replica health, fleet KV load, aggregate prefix-cache
hits, and fleet throughput against the SLOWEST replica's virtual clock
(replicas decode in parallel, so the fleet makespan is the max, and
fleet throughput is how the multi-replica trajectory in bench_serving
shows its scaling).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.obs.stats import summarize_records
from repro_torch.serving.metrics import MetricsRegistry


class ClusterMetrics:
    """Aggregates a ``Router``'s replicas; built by the Router itself."""

    def __init__(self, router):
        self.router = router

    def merged_registry(self) -> MetricsRegistry:
        merged = MetricsRegistry()
        for rep in self.router.replicas:
            merged.records.extend(rep.server.metrics.records)
        return merged

    def per_replica(self) -> List[Dict]:
        out = []
        for rep in self.router.replicas:
            eng = rep.server.engine
            s = rep.server.metrics.summary(eng)
            s.update(state=rep.state, role=rep.role,
                     dispatched=rep.dispatched,
                     completed=rep.completed, kv_load=rep.kv_load(),
                     admitted=rep.server.admission.admitted,
                     deferred=rep.server.admission.deferrals,
                     disconnects=rep.server.disconnects,
                     migrated_in=rep.migrated_in,
                     migrated_out=rep.migrated_out,
                     error=repr(rep.error) if rep.error else None)
            if eng.ec.prefix_cache:
                s["prefix_hit_tokens"] = eng.prefix_hit_tokens
                s["remote_prefix_hits"] = eng.remote_prefix_hits
            out.append(s)
        return out

    def disaggregation(self) -> Dict:
        """Fleet TTFT split for migrated requests: time-to-first-token on
        the prefill side, the modeled KV-link transfer, and per-replica
        migration counts. Empty counters mean no KV ever moved."""
        moves = self.router.migrations
        prefills = [m["prefill_s"] for m in moves
                    if m.get("prefill_s") is not None]
        transfers = [m["transfer_s"] for m in moves]
        out: Dict = {
            "migrations": len(moves),
            "migrated_kv_tokens": sum(m["kv_tokens"] for m in moves),
            "prefill_s_mean": float(np.mean(prefills)) if prefills
            else None,
            "transfer_s_mean": float(np.mean(transfers)) if transfers
            else None,
            "migrated_in_by_replica": [rep.migrated_in
                                       for rep in self.router.replicas],
            "migrated_out_by_replica": [rep.migrated_out
                                        for rep in self.router.replicas],
        }
        tier = self.router.prefix_tier
        if tier is not None:
            out["prefix_tier"] = tier.stats()
        return out

    def summary(self) -> Dict:
        reps = self.router.replicas
        # same shared aggregate body as MetricsRegistry.summary
        # (repro_torch.obs.stats), over the fleet-merged raw records
        out = summarize_records(self.merged_registry().records)
        out["replicas"] = len(reps)
        out["replica_states"] = [rep.state for rep in reps]
        out["replica_roles"] = [rep.role for rep in reps]
        out["dispatched_by_replica"] = [rep.dispatched for rep in reps]
        out["completed_by_replica"] = [rep.completed for rep in reps]
        out["failovers"] = self.router.failovers
        out["routing_policy"] = self.router.policy.name
        out["admitted"] = sum(rep.server.admission.admitted for rep in reps)
        out["deferred"] = sum(rep.server.admission.deferrals for rep in reps)
        out["disconnects"] = sum(rep.server.disconnects for rep in reps)
        out["kv_load_by_replica"] = [rep.kv_load() for rep in reps]
        # fleet makespan = slowest replica's virtual clock (they advance
        # in parallel); throughput is fleet tokens over that makespan
        clocks = [rep.server.engine.clock for rep in reps]
        out["virtual_time_s"] = max(clocks) if clocks else 0.0
        out["virtual_time_by_replica"] = clocks
        if out["virtual_time_s"] > 0:
            out["fleet_throughput_tok_per_s"] = (
                out["tokens"] / out["virtual_time_s"])
        out["prefix_hit_tokens"] = sum(
            rep.server.engine.prefix_hit_tokens for rep in reps)
        if self.router.migrations or any(rep.role != "unified"
                                         for rep in reps):
            out["disaggregation"] = self.disaggregation()
        if self.router.control is not None:
            out.update(self.router.control.summary())
        return out
