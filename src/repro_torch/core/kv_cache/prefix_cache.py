"""Prefix-aware caching (survey dim 2b-ii): RadixAttention-style radix tree.

Port of ``repro.core.kv_cache.prefix_cache``: pure host Python, the
reference's code over the port's ``BlockAllocator``.

A radix tree over token-id sequences maps shared prefixes (system prompts,
repeated images -- visual tokens hash to ids too) to physical KV blocks.
LRU eviction respects reference counts so actively-used entries survive
continuous batching (SGLang's design); ``match_prefix`` returns the longest
cached prefix and pins its blocks.

Entries are NAMESPACED by compression ``variant`` (one radix tree per
variant): KV blocks written under one visual-token-compression strategy
are not interchangeable with another's, so a ``fastv-0.5`` prefill must
never serve a ``none`` lookup -- same rule the serving engine's host
prefix map applies.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.kv_cache.paged import BlockAllocator

_clock = itertools.count()


@dataclasses.dataclass
class RadixNode:
    key: Tuple[int, ...]                       # edge label (token ids)
    block_ids: List[int]                       # blocks covering this edge
    children: Dict[int, "RadixNode"]
    parent: Optional["RadixNode"]
    ref: int = 0                               # active readers
    last_access: int = 0

    def tokens_len(self) -> int:
        return len(self.key)


class RadixPrefixCache:
    #: variant key used when callers do not namespace (back-compat)
    DEFAULT_VARIANT = "none"

    def __init__(self, allocator: BlockAllocator,
                 block_size: Optional[int] = None):
        self.alloc = allocator
        self.block_size = block_size or allocator.block_size
        # one radix tree per compression variant; ``root`` stays the
        # default-variant tree for existing callers
        self.roots: Dict[str, RadixNode] = {}
        self.root = self._variant_root(self.DEFAULT_VARIANT)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.total_tokens = 0

    def _variant_root(self, variant: Optional[str]) -> RadixNode:
        v = variant if variant is not None else self.DEFAULT_VARIANT
        node = self.roots.get(v)
        if node is None:
            node = RadixNode((), [], {}, None)
            self.roots[v] = node
        return node

    def _split_edge(self, parent: RadixNode, child: RadixNode,
                    split: int) -> RadixNode:
        """Split ``child``'s edge after ``split`` tokens (block multiple)."""
        bs = self.block_size
        assert split % bs == 0 and 0 < split < len(child.key)
        nsb = split // bs
        upper = RadixNode(child.key[:split], child.block_ids[:nsb], {},
                          parent, last_access=next(_clock))
        old_first = child.key[0]
        child.key = child.key[split:]
        child.block_ids = child.block_ids[nsb:]
        child.parent = upper
        upper.children[child.key[0]] = child
        parent.children[old_first] = upper
        return upper

    # ------------------------------------------------------------- match --
    def match_prefix(self, tokens: Sequence[int],
                     variant: Optional[str] = None
                     ) -> Tuple[List[int], int, List[RadixNode]]:
        """Longest cached prefix of ``tokens`` under compression
        ``variant`` (None -> the default namespace).

        Returns (block_ids, matched_token_count, pinned_nodes). Caller must
        ``unpin`` the nodes when the request finishes. Only whole-block
        multiples are reusable (partial blocks would need copy-on-write).
        """
        node = self._variant_root(variant)
        matched: List[int] = []
        pinned: List[RadixNode] = []
        i = 0
        tokens = tuple(tokens)
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            common = 0
            while (common < len(child.key) and i + common < len(tokens)
                   and child.key[common] == tokens[i + common]):
                common += 1
            if common < len(child.key):
                # partial edge: split at a block boundary and reuse the top
                split = (common // self.block_size) * self.block_size
                if split == 0:
                    break
                upper = self._split_edge(node, child, split)
                matched.extend(upper.block_ids)
                upper.ref += 1
                upper.last_access = next(_clock)
                pinned.append(upper)
                i += split
                break
            matched.extend(child.block_ids)
            child.ref += 1
            child.last_access = next(_clock)
            pinned.append(child)
            i += common
            node = child
        self.total_tokens += len(tokens)
        if i:
            self.hits += 1
            self.hit_tokens += i
        else:
            self.misses += 1
        return matched, i, pinned

    def unpin(self, pinned: List[RadixNode]) -> None:
        for n in pinned:
            n.ref -= 1
            assert n.ref >= 0

    # ------------------------------------------------------------ insert --
    def insert(self, tokens: Sequence[int], block_ids: Sequence[int],
               block_size: int, variant: Optional[str] = None) -> None:
        """Register a computed prefix under compression ``variant``;
        takes shared ownership of blocks."""
        tokens = tuple(tokens)
        usable = (len(tokens) // block_size) * block_size
        tokens = tokens[:usable]
        block_ids = list(block_ids[:usable // block_size])
        if not tokens:
            return
        node = self._variant_root(variant)
        i = 0
        bi = 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                key = tokens[i:]
                blocks = block_ids[bi:]
                for blk in blocks:
                    self.alloc.share(blk)
                new = RadixNode(key, blocks, {}, node,
                                last_access=next(_clock))
                node.children[tokens[i]] = new
                return
            common = 0
            max_c = min(len(child.key), len(tokens) - i)
            while common < max_c and child.key[common] == tokens[i + common]:
                common += 1
            if common == len(child.key):
                node = child
                i += common
                bi += len(child.key) // block_size
                continue
            # split the edge at a block boundary
            split = (common // block_size) * block_size
            if split == 0:
                return                      # divergence inside first block
            node = self._split_edge(node, child, split)
            i += split
            bi += split // block_size

    # ------------------------------------------------------------- evict --
    def evict(self, num_blocks: int) -> int:
        """LRU-evict leaf nodes (ref==0, any variant) until ``num_blocks``
        are released."""
        released = 0
        while released < num_blocks:
            leaves = [n for n in self._iter_nodes()
                      if not n.children and n.ref == 0
                      and n.parent is not None]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_access)
            for blk in victim.block_ids:
                self.alloc.free(blk)
                released += 1
            first = victim.key[0]
            del victim.parent.children[first]
        return released

    def _iter_nodes(self):
        stack = list(self.roots.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def stats(self) -> Dict:
        nodes = list(self._iter_nodes())
        return {
            "nodes": len(nodes) - len(self.roots),
            "cached_blocks": sum(len(n.block_ids) for n in nodes),
            "hit_rate": self.hits / max(1, self.hits + self.misses),
            "token_hit_rate": self.hit_tokens / max(1, self.total_tokens),
        }
