"""``repro_torch.cluster`` -- multi-engine routing: one surface, N engines.

Port of ``repro.cluster``.

One KV pool and one FIFO cannot serve heavy open-loop traffic; at fleet
scale, scheduling and cache-affinity decisions dominate tail latency.
This layer fronts N ``AsyncLVLMServer`` replicas (possibly heterogeneous
-- different compression presets, decoder defaults, draft models) behind
the exact serving contract clients already use:

    router = lvlm.serve_cluster(replicas=2, routing="prefix_affinity")
    async with router:
        async for tok in router.submit(req):
            ...
    print(router.summary())           # fleet-wide percentiles + routing

Three planes over the serving layer:

  router.py    ``Router`` / ``Replica`` / ``RouterStream`` -- dispatch,
               replica health (ok / draining / dead), drain lifecycle,
               and consumer-transparent FAILOVER: a dead pump's
               queued-but-unstarted requests re-dispatch to a sibling
               (started streams re-raise; emitted tokens are never
               re-run).
  policies.py  ``ROUTING_POLICIES`` -- round_robin, least_kv (KV
               reservations of every assigned request, the engine's
               ``kv_request_tokens`` accounting), and prefix_affinity
               (longest cached block-aligned prefix wins; cold prefixes
               consistent-hash so affinity builds).
  metrics.py   ``ClusterMetrics`` -- merges per-replica registries into
               fleet-wide TTFT/TPOT percentiles, SLO attainment, fleet
               throughput vs the slowest replica's clock, per-replica
               dispatch/health, aggregate prefix hits.

Disaggregated serving (roles): ``serve_cluster(..., roles=["prefill",
"decode"])`` splits the fleet -- prefill replicas run the vision encoder
+ chunked prefill and hand the post-compression KV to decode replicas
over the modeled KV link (``prefix_tier.py`` adds the cluster-shared
radix prefix tier so a prefix cached anywhere short-circuits prefill
everywhere); ``Router.drain`` migrates live KV the same way instead of
merely refusing new work.

SLO-aware dispatch composes from the serving layer: give each replica
``AdmissionConfig(order="slack")`` and its deferred queue drains
earliest-TTFT-deadline-first (deadline minus the live expected TTFT from
``MetricsRegistry``) instead of strict FIFO -- starvation-free because
parked deadlines are fixed while new arrivals' deadlines recede.

With one replica the router is a transparent shim: ``Router.submit``
streams are bit-identical to the bare server at temperature 0
(``tests/test_cluster.py``).
"""
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.policies import (LeastKVPolicy, PrefixAffinityPolicy,
                                    ROUTING_POLICIES, RoundRobinPolicy,
                                    make_policy)
from repro_torch.cluster.prefix_tier import SharedPrefixTier
from repro_torch.cluster.router import ROLES, Replica, Router, RouterStream

__all__ = [
    "Router", "Replica", "RouterStream", "ClusterMetrics",
    "ROLES", "SharedPrefixTier",
    "ROUTING_POLICIES", "make_policy",
    "RoundRobinPolicy", "LeastKVPolicy", "PrefixAffinityPolicy",
]
