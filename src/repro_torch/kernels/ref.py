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


def paged_key_mask(seq_lens, block_table, page: int, *, k_pos=None,
                   q_pos=None, window: int = 0, causal: bool = False):
    """Which tokens of each request's table the paged kernel reads and
    which of those are keys: ``(read, key)``, both [B, pages_per_seq*page].

    A request with seq_len > 0 reads its first seq_len tokens; one with
    seq_len 0 reads every slot of its table and has no key. Masked mode
    (the reference's ``simple_sdpa`` mask over a windowed or compacted
    cache): ``k_pos`` [P, page] int32 is each physical slot's position (-1
    = empty), ``q_pos`` [B] the query's; a read token t is a key iff, where
    ``k_pos`` is given, 0 <= k_pos[t] <= q_pos, and where ``window`` > 0,
    p_t > q_pos - window (p_t = k_pos[t] if given, else t). ``causal``
    (each row one query of the multi-query mode): a read token t is a key
    iff t <= q_pos."""
    n_tok = block_table.shape[1] * page
    dev = block_table.device
    seq = seq_lens.to(dev).long()[:, None]
    pos = torch.arange(n_tok, device=dev)[None]
    read = pos < torch.where(seq > 0, seq, n_tok)
    key = read & (seq > 0)
    if k_pos is not None or window > 0 or causal:
        qp = q_pos.to(dev).long()[:, None]
        p_t = pos
        if k_pos is not None:
            p_t = k_pos[block_table.long()].reshape(-1, n_tok).long()
            key = key & (p_t >= 0) & (p_t <= qp)
        if window > 0:
            key = key & (p_t > qp - window)
        if causal:
            key = key & (p_t <= qp)
    return read, key


def multi_query_rows(q, block_table, seq_lens, q_pos):
    """The multi-query mode's inputs as B*S one-query rows: q [B,S,H,D]
    -> [B*S,H,D]; each query gets its request's table row and seq_len and
    its own position (``q_pos`` [B,S] -> [B*S])."""
    b, s = q.shape[:2]
    return (q.reshape(b * s, *q.shape[2:]),
            block_table.repeat_interleave(s, 0),
            seq_lens.repeat_interleave(s), q_pos.reshape(-1))


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                        k_pos=None, q_pos=None, window: int = 0):
    """Decode attention over a paged KV pool, oracle.

    q          : [B, H, D]           one query token per request
    k_pages    : [P, page, KVH, D]   physical page pool
    v_pages    : [P, page, KVH, D]
    block_table: [B, pages_per_seq]  int32 physical page ids
    seq_lens   : [B]                 int32 valid tokens per request
    k_pos, q_pos, window: the masked mode of ``paged_key_mask``
    Returns [B, H, D]. A read token that is not a key scores the -1e30
    sentinel, one past seq_len is not read: a request with
    ``seq_lens == 0`` gets the mean of V over its table's slots, and a row
    whose read tokens are all masked the mean of V over them.

    Multi-query mode (the per-row-start extend): q [B, S, H, D] with
    ``q_pos`` [B, S], no ``k_pos`` and no window; token t is a key of
    query i iff t < seq_lens[b] and t <= q_pos[b, i]. Returns
    [B, S, H, D].
    """
    if q.ndim == 4:
        rows = multi_query_rows(q, block_table, seq_lens, q_pos)
        return _paged_ref(rows[0], k_pages, v_pages, *rows[1:3],
                          q_pos=rows[3], causal=True).reshape(q.shape)
    return _paged_ref(q, k_pages, v_pages, block_table, seq_lens,
                      k_pos=k_pos, q_pos=q_pos, window=window)


def _paged_ref(q, k_pages, v_pages, block_table, seq_lens, *, k_pos=None,
               q_pos=None, window: int = 0, causal: bool = False):
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    pages_per_seq = block_table.shape[1]
    g = h // kvh
    bt = block_table.long()
    k_log = k_pages[bt].reshape(b, pages_per_seq * page, kvh, d)
    v_log = v_pages[bt].reshape(b, pages_per_seq * page, kvh, d)
    qf = q.reshape(b, kvh, g, d).float() / (d ** 0.5)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_log.float())
    read, key = paged_key_mask(seq_lens, block_table, page, k_pos=k_pos,
                               q_pos=q_pos, window=window, causal=causal)
    s = torch.where(key[:, None, None], s, torch.full_like(s, NEG_INF))
    s = torch.where(read[:, None, None], s, torch.full_like(s, -torch.inf))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_log.float())
    return o.reshape(b, h, d).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
