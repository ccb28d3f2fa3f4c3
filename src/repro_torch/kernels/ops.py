"""Kernel entry points with the reference's shape checks.

Port of ``repro.kernels.ops``. The device decides: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor runs the Hopper kernel or
raises. There is no fallback from the kernel to the plain version; the
oracles themselves are ``repro_torch.kernels.ref``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.mla_attention import mla_attention as _mla
from repro_torch.kernels.paged_attention import paged_attention as _paged


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None):
    """GQA flash attention. q [B,H,Sq,D]; k [B,KVH,Sk,D], v [B,KVH,Sk,Dv]
    -> [B,H,Sq,Dv]. ``scale`` None is 1/sqrt(D). Unlike the reference, v
    may be narrower than k (MLA's prefill)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention expects rank-4 q/k/v")
    if k.shape[:3] != v.shape[:3]:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q/k incompatible: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError("H must be a multiple of KVH")
    return _flash(q, k, v, causal=causal, window=window, kv_len=kv_len,
                  q_offset=q_offset, scale=scale)


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                    k_pos=None, q_pos=None, window: int = 0):
    """Paged decode attention. q [B,H,D] -> [B,H,D]. ``k_pos`` [P,page],
    ``q_pos`` [B] and ``window``: the kernel's masked mode (windowed and
    compacted caches). q [B,S,H,D] with ``q_pos`` [B,S] -> [B,S,H,D]: the
    multi-query mode (per-row-start extend; key t of query i iff
    t < seq_lens[b] and t <= q_pos[b, i])."""
    if q.ndim not in (3, 4) or k_pages.ndim != 4:
        raise ValueError("paged_attention expects q rank-3 (or rank-4, "
                         "multi-query), pages rank-4")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages shape mismatch")
    if block_table.ndim != 2 or block_table.shape[0] != q.shape[0]:
        raise ValueError("block_table must be [B, pages_per_seq]")
    if q.shape[-2] % k_pages.shape[2]:
        raise ValueError("H must be a multiple of KVH")
    if q.shape[-1] != k_pages.shape[3]:
        raise ValueError(f"q head dim {q.shape[-1]} vs pages "
                         f"{k_pages.shape[3]}")
    if k_pos is not None and tuple(k_pos.shape) != tuple(k_pages.shape[:2]):
        raise ValueError(f"k_pos must be [P, page] = "
                         f"{list(k_pages.shape[:2])}, got {list(k_pos.shape)}")
    if (k_pos is not None or window or q.ndim == 4) and q_pos is None:
        raise ValueError("k_pos, window or a multi-query q needs q_pos")
    return _paged(q, k_pages, v_pages, block_table, seq_lens, k_pos=k_pos,
                  q_pos=q_pos, window=window)


def mla_attention(q_lat, q_rope, ckv, k_rope, q_pos, *, k_pos=None,
                  window: int = 0, scale: float):
    """Absorbed MLA attention over a latent cache. q_lat [B,Sq,H,R],
    q_rope [B,Sq,H,Rr] float32; ckv [B,L,R], k_rope [B,L,Rr]; q_pos
    [B,Sq]; ``k_pos`` [B,L] (a windowed cache's slot positions) and
    ``window`` as the reference's decode mask -> o_lat [B,Sq,H,R] f32."""
    if q_lat.ndim != 4 or q_rope.ndim != 4 or ckv.ndim != 3 \
            or k_rope.ndim != 3:
        raise ValueError("mla_attention expects rank-4 queries and a rank-3 "
                         "latent cache")
    if q_lat.shape[:3] != q_rope.shape[:3]:
        raise ValueError(f"q_lat/q_rope mismatch: {tuple(q_lat.shape)} vs "
                         f"{tuple(q_rope.shape)}")
    if ckv.shape[:2] != k_rope.shape[:2] or ckv.shape[0] != q_lat.shape[0]:
        raise ValueError(f"ckv/k_rope/q incompatible: {tuple(ckv.shape)}, "
                         f"{tuple(k_rope.shape)}, {tuple(q_lat.shape)}")
    if q_lat.shape[3] != ckv.shape[2] or q_rope.shape[3] != k_rope.shape[2]:
        raise ValueError(f"latent widths differ: q_lat {q_lat.shape[3]} vs "
                         f"ckv {ckv.shape[2]}, q_rope {q_rope.shape[3]} vs "
                         f"k_rope {k_rope.shape[2]}")
    if tuple(q_pos.shape) != tuple(q_lat.shape[:2]):
        raise ValueError(f"q_pos must be {list(q_lat.shape[:2])}, got "
                         f"{list(q_pos.shape)}")
    if k_pos is not None and tuple(k_pos.shape) != tuple(ckv.shape[:2]):
        raise ValueError(f"k_pos must be {list(ckv.shape[:2])}, got "
                         f"{list(k_pos.shape)}")
    return _mla(q_lat, q_rope, ckv, k_rope, q_pos, k_pos=k_pos, window=window,
                scale=scale)
