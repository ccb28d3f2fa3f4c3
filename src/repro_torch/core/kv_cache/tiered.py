"""Tiered heterogeneous KV storage (survey dim 2b-iii): InfLLM / FlexGen /
PQCache / SqueezedAttention flavors.

HBM tier = device arrays; HOST tier = numpy (stands in for CPU DRAM/NVMe).
Every cross-tier move is metered against configured link bandwidths so the
benchmarks report realistic transfer budgets (PCIe-class for host<->HBM).
Retrieval supports:
  * block-mean index      (InfLLM representative keys)
  * k-means centroids     (SqueezedAttention clustering)
  * product quantization  (PQCache codes; asymmetric distance scoring)
plus an async-prefetch simulator that overlaps fetch with compute.

Port of ``repro.core.kv_cache.tiered``: host numpy, the reference's code,
with the port's own copy of the shared link constant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.roofline.hw import KV_LINK_GBPS


@dataclasses.dataclass
class TierStats:
    bytes_to_host: int = 0
    bytes_to_hbm: int = 0
    fetches: int = 0
    offloads: int = 0

    def transfer_seconds(self, gbps: float = KV_LINK_GBPS) -> float:
        """Total transfer time at ``gbps`` GB/s (shared KV-link constant
        from repro_torch.roofline.hw; pass ``gbps`` to model a different link)."""
        return (self.bytes_to_host + self.bytes_to_hbm) / (gbps * 1e9)


class TieredKVStore:
    """Block-granular two-tier store for one layer's K/V."""

    def __init__(self, block_size: int, num_kv_heads: int, head_dim: int,
                 hbm_capacity_blocks: int, dtype=np.float32,
                 index: str = "mean", pq_subvectors: int = 4,
                 n_centroids: int = 16):
        self.block_size = block_size
        self.h = num_kv_heads
        self.d = head_dim
        self.cap = hbm_capacity_blocks
        self.dtype = dtype
        self.index_kind = index
        self.pq_m = pq_subvectors
        self.n_centroids = n_centroids
        # tiers: block id -> array [block, H, D]
        self.hbm_k: Dict[int, np.ndarray] = {}
        self.hbm_v: Dict[int, np.ndarray] = {}
        self.host_k: Dict[int, np.ndarray] = {}
        self.host_v: Dict[int, np.ndarray] = {}
        self.reprs: Dict[int, np.ndarray] = {}   # block -> index feature
        self.lru: List[int] = []
        self.stats = TierStats()
        self._pq_codebook: Optional[np.ndarray] = None

    def _bytes(self, arr) -> int:
        return arr.nbytes * 2     # K and V

    # ------------------------------------------------------------ insert --
    def insert_block(self, blk_id: int, k: np.ndarray, v: np.ndarray):
        """k/v [block, H, D]; newest blocks live in HBM, evicting LRU."""
        self.hbm_k[blk_id] = k
        self.hbm_v[blk_id] = v
        self.lru.append(blk_id)
        self.reprs[blk_id] = self._make_repr(k)
        while len(self.hbm_k) > self.cap:
            victim = self.lru.pop(0)
            if victim not in self.hbm_k:
                continue
            self.host_k[victim] = self.hbm_k.pop(victim)
            self.host_v[victim] = self.hbm_v.pop(victim)
            self.stats.offloads += 1
            self.stats.bytes_to_host += self._bytes(self.host_k[victim])

    def _make_repr(self, k: np.ndarray) -> np.ndarray:
        flat = k.reshape(k.shape[0], -1).astype(np.float32)
        if self.index_kind == "mean":
            return flat.mean(0)
        if self.index_kind == "kmeans":
            return _kmeans_centroids(flat, min(self.n_centroids, len(flat)))
        if self.index_kind == "pq":
            if self._pq_codebook is None:
                self._pq_codebook = _pq_train(flat, self.pq_m,
                                              self.n_centroids)
            return _pq_encode(flat, self._pq_codebook, self.pq_m)
        raise ValueError(self.index_kind)

    # ----------------------------------------------------------- retrieve --
    def score_blocks(self, query: np.ndarray) -> Dict[int, float]:
        """query [H,D] (current step's mean query) -> block scores."""
        q = query.reshape(-1).astype(np.float32)
        out = {}
        for blk, rep in self.reprs.items():
            if self.index_kind == "mean":
                out[blk] = float(rep @ q)
            elif self.index_kind == "kmeans":
                out[blk] = float((rep @ q).max())
            else:  # pq: asymmetric distance via codebook lookup
                out[blk] = float(_pq_score(rep, q, self._pq_codebook,
                                           self.pq_m))
        return out

    def fetch_topk(self, query: np.ndarray, k: int
                   ) -> Tuple[List[int], np.ndarray, np.ndarray]:
        """SparQ/InfLLM retrieval: top-k blocks by index score; host blocks
        are paged back into HBM (metered)."""
        scores = self.score_blocks(query)
        top = sorted(scores, key=scores.get, reverse=True)[:k]
        ks, vs = [], []
        for blk in top:
            if blk in self.host_k:
                self.hbm_k[blk] = self.host_k.pop(blk)
                self.hbm_v[blk] = self.host_v.pop(blk)
                self.stats.fetches += 1
                self.stats.bytes_to_hbm += self._bytes(self.hbm_k[blk])
                self.lru.append(blk)
            ks.append(self.hbm_k[blk])
            vs.append(self.hbm_v[blk])
        return top, np.concatenate(ks, 0), np.concatenate(vs, 0)

    def residency(self) -> Dict:
        return {"hbm_blocks": len(self.hbm_k),
                "host_blocks": len(self.host_k),
                "stats": dataclasses.asdict(self.stats)}


# -------------------------------------------------------------------------
# prefetch overlap simulator
# -------------------------------------------------------------------------

def prefetch_schedule(compute_us_per_step: float, fetch_us_per_block: float,
                      blocks_per_step: int, steps: int,
                      overlap: bool = True) -> Dict:
    """Latency model for InfLLM-style async prefetching.

    With overlap, fetch of step t+1's blocks hides under step t's compute;
    exposed latency = max(0, fetch - compute) per step. Without, they add.
    """
    fetch = fetch_us_per_block * blocks_per_step
    if overlap:
        exposed = max(0.0, fetch - compute_us_per_step)
        total = compute_us_per_step * steps + exposed * (steps - 1) + fetch
    else:
        total = (compute_us_per_step + fetch) * steps
    return {"total_us": total,
            "exposed_fetch_frac": 0.0 if not overlap else
            max(0.0, fetch - compute_us_per_step) / max(fetch, 1e-9)}


# -------------------------------------------------------------------------
# small numpy kmeans / PQ helpers (deterministic)
# -------------------------------------------------------------------------

def _kmeans_centroids(x: np.ndarray, k: int, iters: int = 8) -> np.ndarray:
    idx = np.linspace(0, len(x) - 1, k).astype(int)
    c = x[idx].copy()
    for _ in range(iters):
        d = ((x[:, None] - c[None]) ** 2).sum(-1)
        a = d.argmin(1)
        for j in range(k):
            m = a == j
            if m.any():
                c[j] = x[m].mean(0)
    return c


def _pq_train(x: np.ndarray, m: int, k: int) -> np.ndarray:
    dim = x.shape[1]
    sub = dim // m
    books = []
    for i in range(m):
        books.append(_kmeans_centroids(x[:, i * sub:(i + 1) * sub], k))
    return np.stack(books)            # [m, k, sub]


def _pq_encode(x: np.ndarray, books: np.ndarray, m: int) -> np.ndarray:
    dim = x.shape[1]
    sub = dim // m
    codes = []
    for i in range(m):
        d = ((x[:, None, i * sub:(i + 1) * sub] - books[i][None]) ** 2).sum(-1)
        codes.append(d.argmin(1))
    return np.stack(codes, 1).astype(np.int32)     # [n, m]


def _pq_score(codes: np.ndarray, q: np.ndarray, books: np.ndarray,
              m: int) -> float:
    dim = q.shape[0]
    sub = dim // m
    # asymmetric: dot(query_sub, centroid) table lookup, max over tokens
    table = np.stack([books[i] @ q[i * sub:(i + 1) * sub]
                      for i in range(m)])          # [m, k]
    scores = table[np.arange(m)[None], codes].sum(1)   # [n]
    return float(scores.max())
