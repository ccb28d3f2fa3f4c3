"""Kernel entry points with the reference's shape checks.

Port of ``repro.kernels.ops``. The device decides: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor runs the Hopper kernel or
raises. There is no fallback from the kernel to the plain version; the
oracles themselves are ``repro_torch.kernels.ref``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.paged_attention import paged_attention as _paged


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, q_offset: int = 0):
    """GQA flash attention. q [B,H,Sq,D]; k,v [B,KVH,Sk,D] -> [B,H,Sq,D]."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention expects rank-4 q/k/v")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q/k incompatible: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError("H must be a multiple of KVH")
    return _flash(q, k, v, causal=causal, window=window, kv_len=kv_len,
                  q_offset=q_offset)


def paged_attention(q, k_pages, v_pages, block_table, seq_lens):
    """Paged decode attention. q [B,H,D] -> [B,H,D]."""
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError("paged_attention expects q rank-3, pages rank-4")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages shape mismatch")
    if block_table.ndim != 2 or block_table.shape[0] != q.shape[0]:
        raise ValueError("block_table must be [B, pages_per_seq]")
    if q.shape[1] % k_pages.shape[2]:
        raise ValueError("H must be a multiple of KVH")
    if q.shape[2] != k_pages.shape[3]:
        raise ValueError(f"q head dim {q.shape[2]} vs pages "
                         f"{k_pages.shape[3]}")
    return _paged(q, k_pages, v_pages, block_table, seq_lens)
