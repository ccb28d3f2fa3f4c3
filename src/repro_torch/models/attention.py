"""Attention: GQA full, prefill-into-cache, chunk continuation and decode.

Port of ``repro.models.attention`` (GQA path; MLA comes with the other
architectures). Layouts are the reference's: q [B,S,H,D], caches
[B,L,K,D], GQA computed grouped (q viewed [B,S,K,G,D]) so KV heads are
never repeated.

Where the reference attends with its pure-jnp ``blockwise_sdpa`` (prefill)
and ``simple_sdpa`` (continuation, decode), the port calls the kernels of
``repro_torch.kernels``: flash attention for prefill and scalar-start
continuation, paged attention for decode over the slot cache viewed as a
page pool with the identity block table, and the paged kernel's
multi-query mode for a continuation with per-row [B] starts (the batched
speculative verify and the draft's lead) over the same view. On CPU
tensors the kernels run their plain versions. Windowed ring caches
(``slot_pos``, the compacting engine's position-exact caches) take the
kernels too: prefill attends over the fresh prompt with flash (only the
ring write differs), a scalar-start extend that has not wrapped attends
over the cache's first rows with flash, and decode (windowed, or with
``window > 0``) takes the paged kernel's masked mode with ``slot_pos`` as
the key positions. Three paths do not fit the kernels: caller-supplied
positions, an extend into a ring that has wrapped, and [B] starts on a
windowed cache or with ``window > 0`` (the speculative decoder refuses a
compacting engine, so the engine never makes one). On CPU tensors they
take the plain ``blockwise_sdpa`` / ``simple_sdpa`` below, on CUDA
tensors they raise ``NotImplementedError`` (ROADMAP).

Caches are updated in place (the reference returns updated copies); every
function still returns the cache it was given, as the reference does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import DTYPES, ParamSpec, apply_rope, spec, \
    tree_map_specs

NEG_INF = -1e30


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

def attn_specs(cfg) -> Dict[str, ParamSpec]:
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP queue A, slice 7)")
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": spec((d, h, hd), ("embed", "heads", None)),
        "wk": spec((d, k, hd), ("embed", "kv_heads", None)),
        "wv": spec((d, k, hd), ("embed", "kv_heads", None)),
        "wo": spec((h, hd, d), ("heads", None, "embed")),
    }


# --------------------------------------------------------------------------
# plain grouped SDPA (CPU path of what the kernels do not take)
# --------------------------------------------------------------------------

def _grouped(q, num_kv: int):
    """[B,S,H,D] -> [B,S,K,G,D]."""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def blockwise_sdpa(q, k, v, *, q_pos, k_pos, causal: bool,
                   window: int = 0, block_k: int = 1024):
    """Grouped-query attention with online softmax over KV blocks.

    q: [B,Sq,K,G,D]; k,v: [B,Sk,K,D]; q_pos [Sq], k_pos [Sk] absolute
    positions used for causal/window masking (k_pos < 0 = invalid slot).
    Returns [B,Sq,K*G,Dv].
    """
    b, sq, kh, g, d = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]
    qf = q.float() * (1.0 / (d ** 0.5))
    m = torch.full((b, kh, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kh, g, sq), device=q.device)
    acc = torch.zeros((b, kh, g, sq, dv), device=q.device)
    for k0 in range(0, max(sk, 1), block_k):
        kblk = k[:, k0:k0 + block_k].float()
        vblk = v[:, k0:k0 + block_k].float()
        kp = k_pos[k0:k0 + block_k]
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kblk)
        valid = kp[None, :] >= 0
        if causal:
            valid = valid & (kp[None, :] <= q_pos[:, None])
        if window:
            valid = valid & (kp[None, :] > q_pos[:, None] - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd",
                                                   p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    # [B,K,G,Sq,Dv] -> [B,Sq,K*G,Dv]
    return out.movedim(3, 1).reshape(b, sq, kh * g, dv).to(q.dtype)


def simple_sdpa(q, k, v, *, q_pos, k_pos, causal: bool, window: int = 0):
    """One-shot grouped SDPA: q [B,Sq,K,G,D]; q_pos [B,Sq] or [Sq];
    k_pos [B,Sk] or [Sk] (per-request ragged positions)."""
    b, sq, kh, g, d = q.shape
    dv = v.shape[-1]
    sk = k.shape[1]
    q_pos = torch.as_tensor(q_pos, device=q.device)
    k_pos = torch.as_tensor(k_pos, device=q.device)
    q_pos = q_pos.reshape(-1).expand(b, sq) if q_pos.ndim <= 1 else q_pos
    k_pos = k_pos.expand(b, sk) if k_pos.ndim <= 1 else k_pos
    s = torch.einsum("bqkgd,bckd->bkgqc", q.float() * (1.0 / (d ** 0.5)),
                     k.float())
    valid = k_pos[:, None, :] >= 0                              # [B,Sq,Sk]
    if causal:
        valid = valid & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        valid = valid & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    return out.movedim(3, 1).reshape(b, sq, kh * g, dv).to(q.dtype)


def _off_kernel(x, what: str):
    """CPU tensors take the plain path; on the card, a path the kernels do
    not cover is not served by this slice."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"{what} is not on the port's CUDA kernels yet (ROADMAP queue "
            "A: custom positions, wrapped ring extends, and [B] starts on "
            "a windowed cache)")


# --------------------------------------------------------------------------
# standard GQA layer
# --------------------------------------------------------------------------

def qkv_proj(p, x):
    b, s, d = x.shape
    q = torch.matmul(x, p["wq"].reshape(d, -1)).reshape(b, s, -1,
                                                        p["wq"].shape[-1])
    k = torch.matmul(x, p["wk"].reshape(d, -1)).reshape(b, s, -1,
                                                        p["wk"].shape[-1])
    v = torch.matmul(x, p["wv"].reshape(d, -1)).reshape(b, s, -1,
                                                        p["wv"].shape[-1])
    return q, k, v


def out_proj(p, o):
    b, s = o.shape[:2]
    return torch.matmul(o.reshape(b, s, -1),
                        p["wo"].reshape(-1, p["wo"].shape[-1])).to(o.dtype)


def _prompt_attention(q, k, v, cfg, *, causal, window, positions):
    """Attention of a fresh prompt over itself: the flash kernel at the
    default positions, the plain blockwise path otherwise (CPU only). The
    kernel takes the [B,N,S,D] views of q, k, v as they are (no copy)."""
    if positions is None:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
        return o.transpose(1, 2)
    _off_kernel(q, "attention at caller-supplied positions")
    return blockwise_sdpa(_grouped(q, cfg.num_kv_heads), k, v, q_pos=positions,
                          k_pos=positions, causal=causal, window=window)


def full_attention(p, x, cos, sin, cfg, *, causal=True, window=0,
                   positions=None):
    """Training/prefill attention (no cache returned). ``positions``
    None means arange(S)."""
    q, k, v = qkv_proj(p, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = _prompt_attention(q, k, v, cfg, causal=causal, window=window,
                          positions=positions)
    return out_proj(p, o)


# ---------------------------- KV cache ------------------------------------

def kv_cache_specs(cfg, batch: int, cache_len: int, windowed: bool):
    """ParamSpec tree for one layer's cache (shape + logical axes)."""
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA latent caches are not ported yet (ROADMAP queue A, slice 7)")
    k, hd = cfg.num_kv_heads, cfg.head_dim
    length = min(cache_len, cfg.sliding_window) if windowed else cache_len
    tree = {
        "k": spec((batch, length, k, hd),
                  ("batch", "cache_seq", "kv_heads", None), init="zeros"),
        "v": spec((batch, length, k, hd),
                  ("batch", "cache_seq", "kv_heads", None), init="zeros"),
    }
    if windowed:
        tree["slot_pos"] = spec((batch, length), ("batch", "cache_seq"),
                                init="zeros", dtype="int32")
    return tree


def zeros_from_specs(specs, dtype: str, device):
    """An empty cache from its spec tree: zeros, and -1 (empty slot) in
    ``slot_pos``."""
    def _one(path, s):
        arr = torch.zeros(s.shape, dtype=DTYPES[s.dtype or dtype],
                          device=device)
        if path[-1] == "slot_pos":
            arr -= 1
        return arr
    return tree_map_specs(_one, specs)


def init_kv_cache(cfg, batch, cache_len, windowed, dtype, device):
    return zeros_from_specs(kv_cache_specs(cfg, batch, cache_len, windowed),
                            dtype, device)


def _cache_write_prefill(cache, new_k, new_v, windowed):
    """Write the whole prompt starting at position 0."""
    length = cache["k"].shape[1]
    s_new = new_k.shape[1]
    if windowed:
        # keep only the last ``length`` entries if the prompt overflows
        take = min(s_new, length)
        pos = torch.arange(s_new - take, s_new, device=new_k.device)
        idx = pos % length
        cache["k"][:, idx] = new_k[:, -take:]
        cache["v"][:, idx] = new_v[:, -take:]
        cache["slot_pos"][:, idx] = pos.to(torch.int32)[None]
        return cache
    cache["k"][:, :s_new] = new_k
    cache["v"][:, :s_new] = new_v
    return cache


def _cache_write_decode(cache, new_k, new_v, pos, windowed):
    """Write ONE token per request at per-request position ``pos [B]``."""
    length = cache["k"].shape[1]
    bidx = torch.arange(new_k.shape[0], device=new_k.device)
    slot = pos % length if windowed else pos
    cache["k"][bidx, slot] = new_k[:, 0]
    cache["v"][bidx, slot] = new_v[:, 0]
    if windowed:
        cache["slot_pos"][bidx, slot] = pos.to(torch.int32)
    return cache


def prefill_into_cache(p, x, cos, sin, cfg, cache, *, window=0,
                       positions=None):
    """Prefill attention that also fills the cache starting at pos 0."""
    q, k, v = qkv_proj(p, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # a windowed (ring) cache differs only in where the prompt is written:
    # the attention is over the fresh prompt itself
    cache = _cache_write_prefill(cache, k, v, "slot_pos" in cache)
    o = _prompt_attention(q, k, v, cfg, causal=True, window=window,
                          positions=positions)
    return out_proj(p, o), cache


def _extend_positions(start, s_new: int, device=None):
    """Positions written by an extend: start scalar -> [1,S_new] (shared by
    the batch); start [B] -> [B,S_new] per-request block offsets."""
    start = torch.as_tensor(start, dtype=torch.int64, device=device)
    pos = start[..., None] + torch.arange(s_new, device=start.device)
    return pos[None] if pos.ndim == 1 else pos


def _cache_write_extend(cache, new_k, new_v, start, windowed):
    """Write S_new entries at offset ``start``: a scalar (chunked prefill)
    or [B] per-request starts. Per-request rows routed past the end are
    clipped onto the last position, the engine's scratch slot."""
    length = cache["k"].shape[1]
    s_new = new_k.shape[1]
    dev = new_k.device
    if torch.as_tensor(start).ndim:              # per-request starts [B]
        pos = _extend_positions(start, s_new, dev)          # [B, S_new]
        idx = pos % length if windowed else pos.clamp(0, length - 1)
        bidx = torch.arange(new_k.shape[0], device=dev)[:, None]
        cache["k"][bidx, idx] = new_k
        cache["v"][bidx, idx] = new_v
        if windowed:
            cache["slot_pos"][bidx, idx] = pos.to(torch.int32)
        return cache
    start = int(start)
    if windowed:
        pos = start + torch.arange(s_new, device=dev)
        idx = pos % length
        cache["k"][:, idx] = new_k
        cache["v"][:, idx] = new_v
        cache["slot_pos"][:, idx] = pos.to(torch.int32)[None]
        return cache
    # the reference's dynamic_update_slice clamps the start into range
    start = min(max(start, 0), length - s_new)
    cache["k"][:, start:start + s_new] = new_k
    cache["v"][:, start:start + s_new] = new_v
    return cache


def append_attention(p, x, cos, sin, cfg, cache, start, *, window=0):
    """Multi-token cache continuation: x [B,S_new,d] appended at ``start``
    (scalar, or [B] per-request starts); attends causally against the
    cache (prefix + chunk).

    A scalar start takes the flash kernel over the cache's first
    ``start + S_new`` rows. On a windowed (ring) cache that needs
    ``start + S_new <= L`` and assumes those rows hold positions
    ``0 .. start+S_new-1`` in order -- true of every cache the engine
    extends (a prefill then chunks; compaction runs only after a prompt's
    last chunk). [B] starts on a plain cache take the paged kernel's
    multi-query mode over the slot cache viewed as pages (identity
    table): query i of row b sits at ``q_pos = start[b] + i`` (past
    ``L - 1`` for the engine's inactive rows, whose writes clip onto the
    scratch slot) and sees rows ``t < min(start[b] + S_new, L)`` with
    ``t <= q_pos`` -- ``simple_sdpa``'s rule with ``k_pos = arange(L)``.
    A ring that has wrapped, and [B] starts on a windowed cache or with
    ``window > 0``, take the plain ``simple_sdpa`` over ``slot_pos`` on
    CPU tensors and raise on CUDA."""
    s_new = x.shape[1]
    q, k, v = qkv_proj(p, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    windowed = "slot_pos" in cache
    per_row = torch.as_tensor(start).ndim > 0
    cache = _cache_write_extend(cache, k, v, start, windowed)
    wrapped = windowed and not per_row \
        and int(start) + s_new > cache["k"].shape[1]
    if not per_row and not wrapped:
        start = int(start)
        kv_len = start + s_new
        o = ops.flash_attention(   # views of q and of the cache prefix
            q.transpose(1, 2), cache["k"][:, :kv_len].transpose(1, 2),
            cache["v"][:, :kv_len].transpose(1, 2), causal=True,
            window=window, kv_len=kv_len, q_offset=start)
        return out_proj(p, o.transpose(1, 2)), cache
    if per_row and not windowed and not window:
        q_pos = _extend_positions(start, s_new, x.device)     # [B, S_new]
        k_pages, v_pages, table = _paged_view(cache, x.shape[0])
        o = ops.paged_attention(
            q.contiguous(), k_pages, v_pages, table,
            torch.clamp(q_pos[:, -1] + 1, max=cache["k"].shape[1]
                        ).to(torch.int32), q_pos=q_pos.to(torch.int32))
        return out_proj(p, o), cache
    _off_kernel(x, "per-row [B] starts on a windowed cache" if per_row
                else "an extend into a wrapped ring cache")
    k_pos = (cache["slot_pos"] if windowed
             else torch.arange(cache["k"].shape[1], device=x.device))
    q_pos = _extend_positions(start, s_new, x.device)
    o = simple_sdpa(_grouped(q, cfg.num_kv_heads), cache["k"], cache["v"],
                    q_pos=q_pos, k_pos=k_pos, causal=True, window=window)
    return out_proj(p, o), cache


def _page_size(length: int) -> int:
    """Largest page of 16, 8, 4, 2, 1 tokens that tiles the slot cache."""
    return next(pg for pg in (16, 8, 4, 2, 1) if length % pg == 0)


def _paged_view(cache, b: int):
    """The dense slot cache [B,L,K,D] as the paged kernel's pool: B*L/page
    pages, request b owning pages b*L/page .. (b+1)*L/page - 1 in order
    (the identity block table). Returns (k_pages, v_pages, table)."""
    length, kvh, hd = cache["k"].shape[1:]
    page = _page_size(length)
    n_pages = b * length // page
    table = torch.arange(n_pages, dtype=torch.int32,
                         device=cache["k"].device).view(b, length // page)
    return (cache["k"].reshape(n_pages, page, kvh, hd),
            cache["v"].reshape(n_pages, page, kvh, hd), table)


def decode_attention(p, x, cos, sin, cfg, cache, pos, *, window=0):
    """One-token decode vs cache. x [B,1,d]; pos [B] per-request positions.

    The dense slot cache [B,L,K,D] is a pool of B*L/page pages; request b
    owns pages b*L/page .. (b+1)*L/page - 1 in order (the identity block
    table) and attends to its first min(pos[b]+1, L) rows. A windowed
    cache, or ``window > 0``, takes the kernel's masked mode: the key
    positions are ``slot_pos`` viewed as pages (rows past a compaction's
    budget hold -1), the query's is ``pos``. The query's own key is
    written first, so every row has at least one key.
    """
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().reshape(-1).expand(b)
    q, k, v = qkv_proj(p, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    windowed = "slot_pos" in cache
    cache = _cache_write_decode(cache, k, v, pos, windowed)
    length = cache["k"].shape[1]
    k_pages, v_pages, table = _paged_view(cache, b)
    masked = {}
    if windowed or window:
        masked = dict(q_pos=pos.to(torch.int32), window=window,
                      k_pos=(cache["slot_pos"].reshape(k_pages.shape[:2])
                             if windowed else None))
    # a ring that has wrapped reads all its rows
    seq_lens = torch.clamp(pos + 1, max=length) if windowed else pos + 1
    o = ops.paged_attention(q[:, 0], k_pages, v_pages, table,
                            seq_lens.to(torch.int32), **masked)
    return out_proj(p, o[:, None]), cache
