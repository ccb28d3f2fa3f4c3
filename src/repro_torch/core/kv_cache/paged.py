"""Paged KV cache (survey dim 2b-i): vLLM's PagedAttention.

Port of ``repro.core.kv_cache.paged``. The host-side ``BlockAllocator``
manages a fixed pool of physical blocks with reference counting
(copy-on-write sharing for prefix reuse); it is the reference's numpy
code. ``PagedKVPool`` holds the preallocated physical pages as torch
tensors on an explicit device; sequences address them through
per-request block tables, exactly like vLLM's logical->physical mapping.
One layer's pages, ``pool.k[layer]`` [num_blocks, block_size, H_kv, D],
are the page pool the port's paged decode kernel reads
(``repro_torch.kernels.paged_attention``), with a table built from the
sequences' ``block_ids``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


class OutOfBlocksError(RuntimeError):
    pass


class BlockAllocator:
    """Reference-counted physical block pool (host-side control plane)."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free_list: List[int] = list(range(num_blocks))
        self.ref: np.ndarray = np.zeros(num_blocks, np.int32)

    # -- stats ------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free_list)

    def utilization(self) -> float:
        return 1.0 - self.num_free / self.num_blocks

    # -- ops ---------------------------------------------------------------
    def alloc(self) -> int:
        if not self.free_list:
            raise OutOfBlocksError("paged KV pool exhausted")
        blk = self.free_list.pop()
        self.ref[blk] = 1
        return blk

    def share(self, blk: int) -> int:
        assert self.ref[blk] > 0
        self.ref[blk] += 1
        return blk

    def free(self, blk: int) -> None:
        assert self.ref[blk] > 0, f"double free of block {blk}"
        self.ref[blk] -= 1
        if self.ref[blk] == 0:
            self.free_list.append(blk)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return (n_tokens + self.block_size - 1) // self.block_size


@dataclasses.dataclass
class SeqBlocks:
    """Per-sequence logical->physical mapping."""
    block_ids: List[int]
    length: int = 0                    # tokens written

    def capacity(self, block_size: int) -> int:
        return len(self.block_ids) * block_size


class PagedKVPool:
    """Device-side paged pool for an L-layer attention model.

    Layout: k/v [L, num_blocks, block_size, H_kv, D]. Page-major, so one
    (layer, block) pair is contiguous. Writes land in place (the
    reference's pool returns updated arrays).
    """

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.float32, *,
                 device):
        shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.shape = shape
        self.block_size = block_size

    def _ids(self, block_ids) -> torch.Tensor:
        return torch.as_tensor(block_ids, dtype=torch.long,
                               device=self.k.device)

    def write_prefill(self, seq: SeqBlocks, layer_k, layer_v):
        """layer_k/v [L, S, H, D]: scatter a prompt's KV into its blocks."""
        l, s, h, d = layer_k.shape
        bs = self.block_size
        nb = (s + bs - 1) // bs
        assert nb <= len(seq.block_ids), (nb, len(seq.block_ids))
        pad = nb * bs - s
        kb = F.pad(layer_k, (0, 0, 0, 0, 0, pad)).reshape(l, nb, bs, h, d)
        vb = F.pad(layer_v, (0, 0, 0, 0, 0, pad)).reshape(l, nb, bs, h, d)
        ids = self._ids(seq.block_ids[:nb])
        self.k[:, ids] = kb.to(self.k.dtype)
        self.v[:, ids] = vb.to(self.v.dtype)
        seq.length = s

    def append_token(self, seq: SeqBlocks, k_t, v_t):
        """k_t/v_t [L, H, D]: append one token's KV."""
        pos = seq.length
        blk = seq.block_ids[pos // self.block_size]
        off = pos % self.block_size
        self.k[:, blk, off] = k_t.to(self.k.dtype)
        self.v[:, blk, off] = v_t.to(self.v.dtype)
        seq.length += 1

    def gather(self, seq: SeqBlocks, layer: int):
        """Reference gather of one sequence's KV: ([S,H,D], [S,H,D])."""
        ids = self._ids(seq.block_ids)
        k = self.k[layer, ids].reshape(-1, *self.shape[3:])[:seq.length]
        v = self.v[layer, ids].reshape(-1, *self.shape[3:])[:seq.length]
        return k, v


def fragmentation_waste(seqs: List[SeqBlocks], block_size: int) -> Dict:
    """Internal fragmentation stats: bytes reserved but unused.

    The survey's motivation for PagedAttention: contiguous preallocation
    wastes (max_len - len) per sequence; paging wastes < block_size.
    """
    internal = sum(len(s.block_ids) * block_size - s.length for s in seqs)
    used = sum(s.length for s in seqs)
    return {"internal_slots_wasted": internal,
            "used_slots": used,
            "waste_frac": internal / max(1, internal + used)}
