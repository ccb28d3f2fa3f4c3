"""Attention: GQA full, prefill-into-cache, chunk continuation and decode,
and MLA (DeepSeek-V3 multi-head latent attention).

Port of ``repro.models.attention``. Layouts are the reference's: q
[B,S,H,D], caches [B,L,K,D] (MLA: the latent ``ckv`` [B,L,R] and the
shared rope key ``k_rope`` [B,L,rope]), GQA computed grouped (q viewed
[B,S,K,G,D]) so KV heads are never repeated.

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
the key positions. Three GQA paths do not fit the kernels: caller-supplied
positions, an extend into a ring that has wrapped, and [B] starts on a
windowed cache or with ``window > 0`` (the speculative decoder refuses a
compacting engine, so the engine never makes one). On CPU tensors they
take the plain ``blockwise_sdpa`` / ``simple_sdpa`` below, on CUDA
tensors they raise ``NotImplementedError`` (ROADMAP).

MLA runs the reference's two forms. Prefill, forward and a scalar-start
extend take the naive form on the flash kernel (per-head k and v expanded
from the latent by ``wk_b`` / ``wv_b``, heads ungrouped, q/k zero-padded
to one of the kernel's head dims, the softmax scale of the unpadded
width; v keeps its width where the kernel takes it and no gradient is
recorded -- deepseek-v3's 128-wide v beside q/k 192 -- and is padded as
q/k otherwise). Decode takes the absorbed form on the latent kernel
(``kernels.mla_attention``: q_lat = q_nope wk_b, scores, softmax and
o_lat in float32, then wv_b and wo), and so do [B]-start extends (the
speculative verify) and an extend into a wrapped ring, where the
reference uses the naive form (ROADMAP C3). Windowed latent caches take
the latent kernel's ``k_pos`` mode with ``slot_pos`` as the key
positions; the engine never makes one (its compaction refuses MLA).
Caller-supplied positions take the plain path on CPU tensors and raise on
CUDA, as for GQA.

Cross-attention (whisper's decoder over its encoder's frames) takes the
kernels too: its prefill runs the flash kernel's non-causal mode, the
prompt's queries over every encoder key (Sq != Sk, no mask), and its
decode the paged kernel's one-query mode over the cross cache viewed as
pages, every row read.

Caches are updated in place (the reference returns updated copies); every
function still returns the cache it was given, as the reference does.

Under a mesh (``sharding.use_mesh``) activations, params and caches are
DTensors. A kernel call and the cache writes around it then run on each
rank's local shards (``_region``, ``sharding.context.local``): sharded on
the batch and heads dims only, so a cache whose ``cache_seq`` is sharded
over "model" is gathered first (its rows written back afterwards), where
the reference's partitioner attends with a partial softmax and an
all-reduce instead (ROADMAP C3).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import needs_grad, ops, plain_device
from repro_torch.kernels.flash_attention import \
    HEAD_DIM_PAIRS as _FLASH_HEAD_DIM_PAIRS, HEAD_DIMS as _FLASH_HEAD_DIMS
from repro_torch.models.layers import DTYPES, ParamSpec, apply_rope, spec, \
    tree_map_specs
from repro_torch.sharding.context import Arg, einsum, local, matmul

NEG_INF = -1e30


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

def attn_specs(cfg) -> Dict[str, ParamSpec]:
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.use_mla:
        qk_hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        out = {
            "wkv_a": spec((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                          ("embed", None)),
            "kv_norm": spec((cfg.kv_lora_rank,), (None,), init="ones"),
            "wk_b": spec((cfg.kv_lora_rank, h, cfg.qk_nope_head_dim),
                         (None, "heads", None)),
            "wv_b": spec((cfg.kv_lora_rank, h, cfg.v_head_dim),
                         (None, "heads", None)),
            "wo": spec((h, cfg.v_head_dim, d), ("heads", None, "embed")),
        }
        if cfg.q_lora_rank:
            out["wq_a"] = spec((d, cfg.q_lora_rank), ("embed", None))
            out["q_norm"] = spec((cfg.q_lora_rank,), (None,), init="ones")
            out["wq_b"] = spec((cfg.q_lora_rank, h, qk_hd),
                               (None, "heads", None))
        else:
            out["wq"] = spec((d, h, qk_hd), ("embed", "heads", None))
        return out
    return {
        "wq": spec((d, h, hd), ("embed", "heads", None)),
        "wk": spec((d, k, hd), ("embed", "kv_heads", None)),
        "wv": spec((d, k, hd), ("embed", "kv_heads", None)),
        "wo": spec((h, hd, d), ("heads", None, "embed")),
    }


def cross_attn_specs(cfg) -> Dict[str, ParamSpec]:
    return attn_specs(cfg)


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
    if not plain_device(x):
        raise NotImplementedError(
            f"{what} is not on the port's CUDA kernels yet (ROADMAP queue "
            "A: custom positions, wrapped ring extends, and [B] starts on "
            "a windowed cache)")


#: the heads dim of a layer's cache leaves ([B,L,K,D] K and V; MLA's latent
#: rows and ``slot_pos`` have none)
_CACHE_HEADS = {"k": 2, "v": 2}


def _region(fn, cache, tensors, outs=((0, 2),)):
    """``fn(c, t)`` on each rank's local shards (``sharding.context.local``):
    ``c`` the cache leaves (batch dim 0, K/V heads dim 2, written in
    place), ``t`` the named ``tensors`` given as (tensor, batch dim, heads
    dim) triples. ``outs`` are fn's outputs' (batch
    dim, heads dim). Without a DTensor this is ``fn(cache, tensors)``."""
    ckeys = list(cache or {})
    tkeys = list(tensors)
    args = [Arg(cache[k], 0, _CACHE_HEADS.get(k), inplace=True)
            for k in ckeys]
    args += [Arg(*tensors[k]) for k in tkeys]

    def core(*ts):
        return fn(dict(zip(ckeys, ts[:len(ckeys)])),
                  dict(zip(tkeys, ts[len(ckeys):])))
    return local(core, args, outs)


# --------------------------------------------------------------------------
# standard GQA layer
# --------------------------------------------------------------------------

def _heads(x, w):
    """x [B,S,d] through w [d,N,D] -> [B,S,N,D]."""
    b, s, d = x.shape
    return matmul(x, w.reshape(d, -1)).reshape(b, s, -1, w.shape[-1])


def qkv_proj(p, x):
    return _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])


def out_proj(p, o):
    b, s = o.shape[:2]
    return matmul(o.reshape(b, s, -1),
                  p["wo"].reshape(-1, p["wo"].shape[-1])).to(o.dtype)


def _prompt_attention(q, k, v, cfg, *, causal, window, positions):
    """Attention of a fresh prompt over itself: the flash kernel at the
    default positions, the plain blockwise path otherwise (CPU only). The
    kernel takes the [B,N,S,D] views of q, k, v as they are (no copy)."""
    if positions is None:
        def flash(_, t):
            o = ops.flash_attention(t["q"].transpose(1, 2),
                                    t["k"].transpose(1, 2),
                                    t["v"].transpose(1, 2), causal=causal,
                                    window=window)
            return o.transpose(1, 2)
        return _region(flash, None, {"q": (q, 0, 2), "k": (k, 0, 2),
                                     "v": (v, 0, 2)})
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
    """ParamSpec tree for one layer's cache (shape + logical axes): K and
    V, or MLA's latent ``ckv`` [B,L,kv_lora_rank] and shared rope key
    ``k_rope`` [B,L,qk_rope_head_dim]."""
    k, hd = cfg.num_kv_heads, cfg.head_dim
    length = min(cache_len, cfg.sliding_window) if windowed else cache_len
    if cfg.use_mla:
        tree = {
            "ckv": spec((batch, length, cfg.kv_lora_rank),
                        ("batch", "cache_seq", None), init="zeros"),
            "k_rope": spec((batch, length, cfg.qk_rope_head_dim),
                           ("batch", "cache_seq", None), init="zeros"),
        }
    else:
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


def _new_args(new):
    return {"new/" + k: (v, 0, _CACHE_HEADS.get(k)) for k, v in new.items()}


def _news(t):
    return {k[4:]: v for k, v in t.items() if k.startswith("new/")}


def _cache_write_prefill(cache, new, windowed):
    """Write the whole prompt starting at position 0. ``new`` maps cache
    keys (``k`` and ``v``, or MLA's ``ckv`` and ``k_rope``) to their
    [B,S_new,...] entries."""
    _region(lambda c, t: _write_prefill(c, _news(t), windowed), cache,
            _new_args(new), ())
    return cache


def _write_prefill(cache, new, windowed):
    first = next(iter(new.values()))
    length = cache[next(iter(new))].shape[1]
    s_new = first.shape[1]
    if windowed:
        # keep only the last ``length`` entries if the prompt overflows
        take = min(s_new, length)
        pos = torch.arange(s_new - take, s_new, device=first.device)
        idx = pos % length
        for key, val in new.items():
            cache[key][:, idx] = val[:, -take:]
        cache["slot_pos"][:, idx] = pos.to(torch.int32)[None]
        return cache
    for key, val in new.items():
        cache[key][:, :s_new] = val
    return cache


def _write_decode(cache, new, pos, windowed):
    """Write ONE token per request at per-request position ``pos [B]``
    (``new`` as ``_cache_write_prefill``)."""
    first = next(iter(new.values()))
    length = cache[next(iter(new))].shape[1]
    bidx = torch.arange(first.shape[0], device=first.device)
    slot = pos % length if windowed else pos
    for key, val in new.items():
        cache[key][bidx, slot] = val[:, 0]
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
    cache = _cache_write_prefill(cache, {"k": k, "v": v}, "slot_pos" in cache)
    o = _prompt_attention(q, k, v, cfg, causal=True, window=window,
                          positions=positions)
    return out_proj(p, o), cache


def _extend_positions(start, s_new: int, device=None):
    """Positions written by an extend: start scalar -> [1,S_new] (shared by
    the batch); start [B] -> [B,S_new] per-request block offsets."""
    start = torch.as_tensor(start, dtype=torch.int64, device=device)
    pos = start[..., None] + torch.arange(s_new, device=start.device)
    return pos[None] if pos.ndim == 1 else pos


def _cache_write_extend(cache, new, start, windowed):
    """``_write_extend`` on each rank's local shards."""
    _region(lambda c, t: _write_extend(c, _news(t), t.get("start", start),
                                       windowed),
            cache, {**_new_args(new), **_start_arg(start)}, ())
    return cache


def _start_arg(start):
    """A [B] tensor of starts as a region argument (batch dim 0); a scalar
    start stays with the caller."""
    if torch.is_tensor(start) and start.ndim:
        return {"start": (start, 0, None)}
    return {}


def _write_extend(cache, new, start, windowed):
    """Write S_new entries at offset ``start``: a scalar (chunked prefill)
    or [B] per-request starts (``new`` as ``_cache_write_prefill``).
    Per-request rows routed past the end are clipped onto the last
    position, the engine's scratch slot."""
    first = next(iter(new.values()))
    length = cache[next(iter(new))].shape[1]
    s_new = first.shape[1]
    dev = first.device
    if torch.as_tensor(start).ndim:              # per-request starts [B]
        pos = _extend_positions(start, s_new, dev)          # [B, S_new]
        idx = pos % length if windowed else pos.clamp(0, length - 1)
        bidx = torch.arange(first.shape[0], device=dev)[:, None]
        for key, val in new.items():
            cache[key][bidx, idx] = val
        if windowed:
            cache["slot_pos"][bidx, idx] = pos.to(torch.int32)
        return cache
    start = int(start)
    if windowed:
        pos = start + torch.arange(s_new, device=dev)
        idx = pos % length
        for key, val in new.items():
            cache[key][:, idx] = val
        cache["slot_pos"][:, idx] = pos.to(torch.int32)[None]
        return cache
    # the reference's dynamic_update_slice clamps the start into range
    start = min(max(start, 0), length - s_new)
    for key, val in new.items():
        cache[key][:, start:start + s_new] = val
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

    def attend(cache, t):
        q, start = t["q"], t.get("start", start0)
        _write_extend(cache, {"k": t["k"], "v": t["v"]}, start, windowed)
        wrapped = windowed and not per_row \
            and int(start) + s_new > cache["k"].shape[1]
        if not per_row and not wrapped:
            start = int(start)
            kv_len = start + s_new
            o = ops.flash_attention(   # views of q and of the cache prefix
                q.transpose(1, 2), cache["k"][:, :kv_len].transpose(1, 2),
                cache["v"][:, :kv_len].transpose(1, 2), causal=True,
                window=window, kv_len=kv_len, q_offset=start)
            return o.transpose(1, 2)
        if per_row and not windowed and not window:
            q_pos = _extend_positions(start, s_new, q.device)  # [B, S_new]
            k_pages, v_pages, table = _paged_view(cache, q.shape[0])
            return ops.paged_attention(
                q.contiguous(), k_pages, v_pages, table,
                torch.clamp(q_pos[:, -1] + 1, max=cache["k"].shape[1]
                            ).to(torch.int32), q_pos=q_pos.to(torch.int32))
        _off_kernel(q, "per-row [B] starts on a windowed cache" if per_row
                    else "an extend into a wrapped ring cache")
        k_pos = (cache["slot_pos"] if windowed
                 else torch.arange(cache["k"].shape[1], device=q.device))
        q_pos = _extend_positions(start, s_new, q.device)
        return simple_sdpa(_grouped(q, cfg.num_kv_heads), cache["k"],
                           cache["v"], q_pos=q_pos, k_pos=k_pos, causal=True,
                           window=window)
    start0 = start
    o = _region(attend, cache, {"q": (q, 0, 2), "k": (k, 0, 2),
                                "v": (v, 0, 2), **_start_arg(start)})
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

    def attend(cache, t):
        pos = t["pos"]
        _write_decode(cache, {"k": t["k"], "v": t["v"]}, pos, windowed)
        length = cache["k"].shape[1]
        k_pages, v_pages, table = _paged_view(cache, pos.shape[0])
        masked = {}
        if windowed or window:
            masked = dict(q_pos=pos.to(torch.int32), window=window,
                          k_pos=(cache["slot_pos"].reshape(k_pages.shape[:2])
                                 if windowed else None))
        # a ring that has wrapped reads all its rows
        seq_lens = torch.clamp(pos + 1, max=length) if windowed else pos + 1
        return ops.paged_attention(t["q"][:, 0], k_pages, v_pages, table,
                                   seq_lens.to(torch.int32), **masked)
    o = _region(attend, cache, {"q": (q, 0, 2), "k": (k, 0, 2),
                                "v": (v, 0, 2), "pos": (pos, 0, None)},
                outs=((0, 1),))
    return out_proj(p, o[:, None]), cache


# ---------------------------- cross-attention ------------------------------

def cross_kv(p, enc):
    """The encoder's keys and values for one layer's cross-attention:
    enc [B,Se,d] -> (k, v) [B,Se,K,D] in enc's dtype."""
    return _heads(enc, p["wk"]), _heads(enc, p["wv"])


def cross_attention(p, x, k, v):
    """Every decoder token of x [B,S,d] over all the encoder's keys k, v
    [B,Se,K,D], unmasked (the reference's ``blockwise_sdpa(...,
    causal=False)``): the flash kernel's non-causal mode on the [B,N,S,D]
    views, Sq = S beside Sk = Se."""
    q = _heads(x, p["wq"])

    def flash(_, t):
        return ops.flash_attention(t["q"].transpose(1, 2),
                                   t["k"].transpose(1, 2),
                                   t["v"].transpose(1, 2),
                                   causal=False).transpose(1, 2)
    o = _region(flash, None, {"q": (q, 0, 2), "k": (k, 0, 2),
                              "v": (v, 0, 2)})
    return out_proj(p, o)


def cross_decode_attention(p, x, cross):
    """One decoder token x [B,1,d] over the cross cache ``cross`` {"k",
    "v"} [B,Se,K,D] (the reference's ``simple_sdpa(..., causal=False)``):
    the paged kernel's one-query mode over the cache viewed as pages with
    the identity table, and ``seq_lens = Se`` (every key read).

    The cache keeps the reference's unpadded [B,Se,K,D] layout, so whisper's
    1500 encoder frames page by 4 tokens (``_page_size``). The paged
    kernel takes the page size as a run-time argument (its chunks gather
    tokens through the table one by one), so page 4 needs no instantiation
    of its own, and the card check holds it there."""
    q = _heads(x, p["wq"])

    def attend(cross, t):
        q = t["q"]
        b = q.shape[0]
        k_pages, v_pages, table = _paged_view(cross, b)
        seq_lens = torch.full((b,), cross["k"].shape[1], dtype=torch.int32,
                              device=q.device)
        return ops.paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                   table, seq_lens)
    o = _region(attend, cross, {"q": (q, 0, 2)}, outs=((0, 1),))
    return out_proj(p, o[:, None])


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# --------------------------------------------------------------------------

def _rms(x, scale, eps=1e-6):
    """RMSNorm in float32 (the result stays float32, as the reference's)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return y * scale.float()


def _mla_q(p, x, cfg, cos, sin):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope]) in x's dtype."""
    b, s, d = x.shape
    if cfg.q_lora_rank:
        ql = _rms(matmul(x, p["wq_a"]), p["q_norm"]).to(x.dtype)
        q = matmul(ql, p["wq_b"].reshape(cfg.q_lora_rank, -1))
    else:
        q = matmul(x, p["wq"].reshape(d, -1))
    q = q.reshape(b, s, cfg.num_heads, -1)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], cos, sin)
    return q_nope, q_rope


def _mla_latent(p, x, cfg, cos, sin):
    """The cache entries of x: (ckv [B,S,R], k_rope [B,S,rope])."""
    kv = matmul(x, p["wkv_a"])
    ckv = _rms(kv[..., :cfg.kv_lora_rank], p["kv_norm"]).to(x.dtype)
    k_rope = kv[..., cfg.kv_lora_rank:].to(x.dtype)
    # rope applied to the shared (MQA-style) rope key
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return ckv, k_rope


def _mla_scale(cfg) -> float:
    return 1.0 / ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** 0.5)


def _mla_naive_kv(p, cfg, ckv, k_rope, dtype):
    """The naive form's per-head keys and values over latent rows:
    k = [ckv wk_b | k_rope] [B,S,H,nope+rope], v = ckv wv_b [B,S,H,v]."""
    k_nope = einsum("bsr,rhe->bshe", ckv, p["wk_b"]).to(dtype)
    v = einsum("bsr,rhe->bshe", ckv, p["wv_b"]).to(dtype)
    kr = k_rope[:, :, None, :].expand(k_rope.shape[:2] + (cfg.num_heads,
                                                          k_rope.shape[-1]))
    return torch.cat([k_nope, kr], -1), v


def _mla_flash(cfg, q, k, v, *, window, kv_len=None, q_offset=0):
    """The naive form on the flash kernel, heads ungrouped (K = H, G = 1).

    q, k [B,S,H,nope+rope] are zero-padded to the kernel's head dim
    ``pad`` (the least of its head dims that holds both widths: 192 at
    deepseek-v3's 192 / 128, 64 at the smoke config's 48 / 32); zero
    columns add exactly 0 to q . k, and the scale stays the unpadded
    width's. v [B,S,H,v] keeps its width where the call takes it: with no
    autograd recording, on the plain version (any width) or on the kernel
    at (pad, v) in its ``HEAD_DIM_PAIRS`` (deepseek-v3's 192 / 128).
    Otherwise (the backward takes equal widths only) v is zero-padded to
    ``pad`` too and its padded columns are sliced off the output."""
    dqk, dv = q.shape[-1], v.shape[-1]
    pad = next(d for d in _FLASH_HEAD_DIMS if d >= max(dqk, dv))

    def flash(_, t):
        narrow = not needs_grad(*t.values()) and (
            plain_device(t["q"]) or (pad, dv) in _FLASH_HEAD_DIM_PAIRS)
        widths = (pad, pad, dv if narrow else pad)
        q, k, v = (F.pad(x, (0, w - x.shape[-1])) if x.shape[-1] < w else x
                   for x, w in zip((t["q"], t["k"], t["v"]), widths))
        return ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, kv_len=kv_len, q_offset=q_offset,
            scale=_mla_scale(cfg)).transpose(1, 2)[..., :dv]
    return _region(flash, None, {"q": (q, 0, 2), "k": (k, 0, 2),
                                 "v": (v, 0, 2)})


def _mla_absorbed(p, cfg, q_nope, q_rope, cache, q_pos, *, window, dtype,
                  write=None, new=None):
    """Attention in the latent space, the reference's absorbed decode:
    q_lat = q_nope wk_b in float32, the latent kernel over the cache
    (``slot_pos`` as its key positions on a windowed cache), then
    o_lat wv_b in float32 and wo. ``q_pos`` [B,Sq]. ``write(cache, new)``,
    where given, first writes the entries ``new`` into the cache (in the
    same local region as the kernel)."""
    q_lat = einsum("bshe,rhe->bshr", q_nope.float(), p["wk_b"].float())

    def attend(cache, t):
        if write is not None:
            write(cache, _news(t), t["q_pos"])
        return ops.mla_attention(
            t["q_lat"].contiguous(), t["q_rope"].float().contiguous(),
            cache["ckv"], cache["k_rope"],
            t["q_pos"].to(torch.int32).contiguous(),
            k_pos=cache.get("slot_pos"), window=window,
            scale=_mla_scale(cfg))
    o_lat = _region(attend, cache,
                    {"q_lat": (q_lat, 0, 2), "q_rope": (q_rope, 0, 2),
                     "q_pos": (q_pos, 0, None), **_new_args(new or {})})
    o = einsum("bshr,rhe->bshe", o_lat, p["wv_b"].float())
    return out_proj(p, o.to(dtype))


def mla_full_attention(p, x, cos, sin, cfg, *, window=0, positions=None,
                       cache=None):
    """Naive (non-absorbed) MLA for forward / prefill; with ``cache`` it
    also writes the prompt's latent rows (ring order on a windowed cache)
    and returns (out, cache). Attention is over the fresh prompt: the
    flash kernel at the default positions, the plain blockwise path at
    caller-supplied ones (CPU only)."""
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)
    ckv, k_rope = _mla_latent(p, x, cfg, cos, sin)
    if cache is not None:
        cache = _cache_write_prefill(cache, {"ckv": ckv, "k_rope": k_rope},
                                     "slot_pos" in cache)
    k, v = _mla_naive_kv(p, cfg, ckv, k_rope, x.dtype)
    q = torch.cat([q_nope, q_rope], -1)
    if positions is None:
        o = _mla_flash(cfg, q, k, v, window=window)
    else:
        _off_kernel(x, "attention at caller-supplied positions")
        b, s, h, dqk = q.shape
        o = blockwise_sdpa(q.reshape(b, s, h, 1, dqk), k, v,
                           q_pos=positions, k_pos=positions, causal=True,
                           window=window)
    out = out_proj(p, o)
    return (out, cache) if cache is not None else out


def mla_append_attention(p, x, cos, sin, cfg, cache, start, *, window=0):
    """MLA chunk continuation against the latent cache: ``start`` scalar
    or [B] per-request offsets.

    A scalar start on a plain cache, or on a ring that has not wrapped,
    takes the reference's naive form on the flash kernel over the cache's
    first ``start + S_new`` rows (``append_attention``'s rule). [B]
    starts (the speculative verify) and an extend into a wrapped ring take
    the absorbed form on the latent kernel: query i of row b at
    ``start[b] + i`` over the whole cache, ``slot_pos`` as the key
    positions on a windowed cache. The reference computes those in the
    naive form; the two agree to float32 rounding (ROADMAP C3)."""
    s_new = x.shape[1]
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)
    ckv_t, k_rope_t = _mla_latent(p, x, cfg, cos, sin)
    windowed = "slot_pos" in cache
    per_row = torch.as_tensor(start).ndim > 0
    cache = _cache_write_extend(cache, {"ckv": ckv_t, "k_rope": k_rope_t},
                                start, windowed)
    length = cache["ckv"].shape[1]
    if per_row or (windowed and int(start) + s_new > length):
        q_pos = _extend_positions(start, s_new, x.device
                                  ).expand(x.shape[0], s_new)
        return _mla_absorbed(p, cfg, q_nope, q_rope, cache, q_pos,
                             window=window, dtype=x.dtype), cache
    start = int(start)
    kv_len = start + s_new
    k, v = _mla_naive_kv(p, cfg, cache["ckv"][:, :kv_len],
                         cache["k_rope"][:, :kv_len], x.dtype)
    o = _mla_flash(cfg, torch.cat([q_nope, q_rope], -1), k, v, window=window,
                   kv_len=kv_len, q_offset=start)
    return out_proj(p, o), cache


def mla_decode_attention(p, x, cos, sin, cfg, cache, pos, *, window=0):
    """Absorbed-form MLA decode: attention runs in the latent space on the
    latent kernel. The per-head key projection wk_b is absorbed into the
    query and wv_b into the output, so the cache holds only [B,L,R] +
    [B,L,rope]: the survey's dimension-2 cache compression built into the
    architecture. pos: [B] per-request positions (or a scalar)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().reshape(-1).expand(b)
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)         # [B,1,H,*]
    ckv_t, k_rope_t = _mla_latent(p, x, cfg, cos, sin)    # [B,1,R], [B,1,rope]
    windowed = "slot_pos" in cache
    return _mla_absorbed(
        p, cfg, q_nope, q_rope, cache, pos[:, None], window=window,
        dtype=x.dtype, new={"ckv": ckv_t, "k_rope": k_rope_t},
        write=lambda c, new, q_pos: _write_decode(c, new, q_pos[:, 0],
                                                  windowed)), cache
