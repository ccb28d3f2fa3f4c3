"""Plain PyTorch oracles for the port's CUDA kernels (the ground truth).

Port of ``repro.kernels.ref``: the same arithmetic in float32, so on the
same inputs these agree with the reference oracles to float32 rounding.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        kv_len: Optional[int] = None, window: int = 0,
                        q_offset: Optional[int] = None):
    """Grouped-query attention oracle.

    q: [B, H, Sq, D];  k, v: [B, KVH, Sk, D];  H = KVH * G.
    ``kv_len``: only the first kv_len keys are valid (padding mask).
    ``window`` > 0: sliding-window causal attention.
    ``q_offset``: absolute position of q[..., 0, :]; None is the
    reference oracle's convention, ``kv_len - Sq`` (the q block sits at
    the end of the kv sequence).
    Returns [B, H, Sq, D] in q.dtype (accumulation in f32).
    """
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.reshape(b, kvh, g, sq, d).float() / (d ** 0.5)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k.float())
    q_pos = torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        valid = valid & (k_pos[None, :] < kv_len)
    if causal:
        offset = q_offset if q_offset is not None else \
            (kv_len if kv_len is not None else sk) - sq
        valid = valid & (k_pos[None, :] <= q_pos[:, None] + offset)
        if window:
            valid = valid & (k_pos[None, :] > q_pos[:, None] + offset - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens):
    """Decode attention over a paged KV pool, oracle.

    q          : [B, H, D]           one query token per request
    k_pages    : [P, page, KVH, D]   physical page pool
    v_pages    : [P, page, KVH, D]
    block_table: [B, pages_per_seq]  int32 physical page ids
    seq_lens   : [B]                 int32 valid tokens per request
    Returns [B, H, D]. Every page of the table is visited, so a request
    with ``seq_lens == 0`` gets the mean of V over its table's slots.
    """
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    pages_per_seq = block_table.shape[1]
    g = h // kvh
    bt = block_table.long()
    k_log = k_pages[bt].reshape(b, pages_per_seq * page, kvh, d)
    v_log = v_pages[bt].reshape(b, pages_per_seq * page, kvh, d)
    qf = q.reshape(b, kvh, g, d).float() / (d ** 0.5)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_log.float())
    pos = torch.arange(pages_per_seq * page, device=q.device)
    valid = pos[None] < seq_lens.to(q.device).long()[:, None]   # [B, C]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_log.float())
    return o.reshape(b, h, d).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
