"""``SharedPrefixTier``: one cluster-wide prefix-KV cache over N engines.

Port of ``repro.cluster.prefix_tier``. A snapshot here is a tuple of
device tensors that the publishing engine cloned out of its pool; the
tier and every engine that installs a hit share it by reference, and
nothing writes through it (``Engine._install_snap`` copies out of it).

Per-replica prefix caches only pay off when the SAME replica sees the
same prefix again -- under round-robin dispatch, or in a role-split
fleet where the prefill replicas cache what the rest never sees, every
other replica pays its own cold prefill. This tier promotes cached
prefixes to a fleet-shared, radix-keyed structure:

  * every ``Engine._prefix_insert`` also publishes (variant, tokens,
    snapshot) here;
  * every ``Engine._prefix_lookup`` probes here after its local cache --
    a LONGER remote hit wins, the engine installs the snapshot into its
    local cache (so later lookups are local) and charges one modeled
    KV-link transfer (``CostModel.transfer_time``) to the step that used
    it. A prefix prefilled on ANY replica short-circuits prefill on
    every replica.

Keys are radix: per compression variant, a trie over fixed-size token
BLOCKS (the engines' ``prefix_block``), so a lookup walks the prompt
block-by-block in O(prompt/block) dict probes and the deepest node with
a snapshot is the longest shared prefix -- no per-entry scans, and
sibling prefixes share their common path. Snapshots are shared by
reference across engines (install copies them into a slot; nothing
mutates them in place).

Eviction is LRU over entries (touched on hit); evicting here is always
safe -- engines pin only their LOCAL copies, and a request decoding from
a tier hit holds a local pin, never a tier reference. The tier is plain
event-loop-confined Python like everything above the engine: no locks.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple


class _Node:
    """One radix-trie node: children keyed by the next token block."""
    __slots__ = ("children", "snap")

    def __init__(self):
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.snap = None            # KV snapshot covering the path here


class SharedPrefixTier:
    """Fleet-shared radix prefix cache (see module docstring).

    Duck-typed against ``Engine.prefix_share``: ``lookup(variant,
    tokens, *, block, touch)`` -> ``(k, snap)`` with ``k == 0`` on miss,
    and ``insert(variant, tokens, snap, k)``.
    """

    def __init__(self, block: int, cap: int = 256):
        if block <= 0:
            raise ValueError("block must be positive")
        self.block = block
        self.cap = cap
        self._roots: Dict[str, _Node] = {}          # variant -> trie root
        # recency over entries: (variant, key tokens) in LRU order; the
        # value is the node holding the snapshot
        self._lru: "collections.OrderedDict[Tuple, _Node]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._lru)

    # ------------------------------------------------------------ probe --
    def lookup(self, variant: str, tokens, *, block: int,
               touch: bool = True) -> Tuple[int, Optional[object]]:
        """Longest cached prefix of ``tokens`` under ``variant``. Returns
        ``(k, snap)``; ``(0, None)`` on miss or when the caller's block
        size disagrees with the tier's (mixed-granularity fleets never
        share keys)."""
        if block != self.block:
            return 0, None
        t = tuple(int(x) for x in tokens)
        node = self._roots.get(variant)
        best_k, best = 0, None
        i = 0
        while node is not None and i + self.block <= len(t):
            node = node.children.get(t[i:i + self.block])
            if node is None:
                break
            i += self.block
            if node.snap is not None:
                best_k, best = i, node.snap
        if best is None:
            self.misses += 1
            return 0, None
        self.hits += 1
        if touch:
            self._lru.move_to_end((variant, t[:best_k]))
        return best_k, best

    # ----------------------------------------------------------- insert --
    def insert(self, variant: str, tokens, snap, k: int) -> None:
        """Publish a ``k``-token prefix snapshot (``k`` must be a positive
        multiple of the tier's block; shorter/ragged keys are ignored --
        the publishing engine aligned them already)."""
        if k <= 0 or k % self.block != 0:
            return
        t = tuple(int(x) for x in tokens)[:k]
        if len(t) < k:
            return
        key = (variant, t)
        if key in self._lru:
            self._lru.move_to_end(key)              # re-insert = LRU touch
            return
        node = self._roots.setdefault(variant, _Node())
        for i in range(0, k, self.block):
            node = node.children.setdefault(t[i:i + self.block], _Node())
        node.snap = snap
        self._lru[key] = node
        self.inserts += 1
        while len(self._lru) > self.cap:
            self._evict_one()

    def _evict_one(self) -> None:
        (variant, t), node = self._lru.popitem(last=False)
        node.snap = None
        self.evictions += 1
        # prune now-useless trie nodes (no snapshot, no children) so a
        # long-dead prefix family does not pin its whole path forever
        self._prune(variant, t)

    def _prune(self, variant: str, t: Tuple[int, ...]) -> None:
        root = self._roots.get(variant)
        if root is None:
            return
        path = [root]
        node = root
        for i in range(0, len(t), self.block):
            node = node.children.get(t[i:i + self.block])
            if node is None:
                return          # path already gone
            path.append(node)
        for depth in range(len(path) - 1, 0, -1):
            node = path[depth]
            if node.children or node.snap is not None:
                break
            edge = t[(depth - 1) * self.block:depth * self.block]
            del path[depth - 1].children[edge]
        if not root.children and root.snap is None:
            self._roots.pop(variant, None)

    # ---------------------------------------------------------- reports --
    def stats(self) -> Dict:
        probes = self.hits + self.misses
        return {
            "entries": len(self._lru),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / probes if probes else 0.0,
            "inserts": self.inserts,
            "evictions": self.evictions,
        }
