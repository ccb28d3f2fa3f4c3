"""Routing policies: which replica serves a new request.

Port of ``repro.cluster.policies`` (same policies, same dispatch order).

Every policy sees only healthy (non-draining, non-dead) candidates and
picks exactly one. Policies are tiny stateful objects so the Router can
hold per-policy state (the round-robin cursor) without globals:

  round_robin      cycle through replicas -- the baseline spreader.
  least_kv         the replica with the lowest committed-KV fraction
                   (``Engine.kv_committed_tokens / kv_capacity_tokens``),
                   i.e. join-the-shortest-queue on the resource that
                   actually gates admission.
  prefix_affinity  the replica whose prefix cache already holds the
                   longest block-aligned prefix of the prompt (so the
                   prefill reuses it); a COLD prefix consistent-hashes
                   its first block, so one prefix family converges on one
                   replica and affinity builds instead of spraying.

Custom policies: any object with ``name`` and
``pick(request, candidates) -> Replica`` works; register it in
``ROUTING_POLICIES`` or pass the instance to ``Router(routing=...)``.
"""
from __future__ import annotations

import zlib
from typing import List, Sequence


class RoundRobinPolicy:
    name = "round_robin"

    def __init__(self):
        self._cursor = 0

    def pick(self, request, candidates: List):
        rep = candidates[self._cursor % len(candidates)]
        self._cursor += 1
        return rep


class LeastKVPolicy:
    """Join-the-shortest-queue on KV reservations (the engine's
    ``kv_request_tokens`` accounting) of every request assigned to the
    replica -- admitted, deferred, or dispatched-but-not-yet-iterated --
    so a replica stops attracting work the moment it is loaded up, not
    once its engine commits."""
    name = "least_kv"

    def pick(self, request, candidates: List):
        return min(candidates,
                   key=lambda rep: (rep.kv_load(), rep.queue_depth(),
                                    rep.index))


def _hash_block(tokens: Sequence[int], block: int) -> int:
    """Deterministic hash of the prompt's first prefix block (crc32 over
    the token bytes -- stable across processes, unlike ``hash``)."""
    head = ",".join(str(int(t)) for t in tokens[:block])
    return zlib.crc32(head.encode())


class PrefixAffinityPolicy:
    """Route to the replica that already caches the longest prefix of the
    prompt; consistent-hash cold prefixes so repeats land together."""
    name = "prefix_affinity"

    def pick(self, request, candidates: List):
        best, best_len = None, 0
        for rep in candidates:
            # prefix entries are keyed by compression variant too: a
            # replica only counts as warm if it cached the prefix under
            # THIS request's strategy
            n = rep.cached_prefix_len(request.tokens,
                                      getattr(request, "compression", None))
            if n > best_len:
                best, best_len = rep, n
        if best is not None:
            return best
        block = max((rep.prefix_block() for rep in candidates), default=16)
        h = _hash_block(request.tokens, block)
        return candidates[h % len(candidates)]


def replica_keep_fraction(rep, probe: int = 256) -> float:
    """Fraction of visual tokens the replica's DEFAULT compression
    strategy keeps, probed exactly via
    ``CompressionStrategy.compressed_token_count`` (the same accounting
    admission uses -- no heuristics)."""
    comp = rep.server.engine.compressor
    if comp is None or probe <= 0:
        return 1.0
    return comp.compressed_token_count(probe) / float(probe)


def prefer_aggressive(candidates: Sequence, max_keep: float = 0.5) -> List:
    """Candidates whose default strategy keeps at most ``max_keep`` of
    visual tokens -- the SLO-adaptive controller's routing bias for
    video-heavy traffic under pressure. Empty when none qualify (the
    caller falls back to the full list)."""
    return [rep for rep in candidates
            if replica_keep_fraction(rep) <= max_keep]


ROUTING_POLICIES = {
    "round_robin": RoundRobinPolicy,
    "least_kv": LeastKVPolicy,
    "prefix_affinity": PrefixAffinityPolicy,
}


def make_policy(routing):
    """Name -> fresh policy instance; a policy object passes through."""
    if isinstance(routing, str):
        if routing not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {routing!r}; known: "
                             f"{sorted(ROUTING_POLICIES)}")
        return ROUTING_POLICIES[routing]()
    if not hasattr(routing, "pick"):
        raise TypeError("routing must be a policy name or an object with "
                        "a pick(request, candidates) method")
    return routing
