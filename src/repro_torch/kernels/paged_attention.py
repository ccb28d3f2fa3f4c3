"""Paged decode attention: the decode kernel of the port.

Replaces the Pallas TPU kernel ``paged_attention`` (``_paged_kernel``) of
``src/repro/kernels/paged_attention.py`` with a CUDA C++ kernel for
Hopper, ``csrc/paged_attention.cu`` (design and bound in its header). On a
CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor it
runs ``paged_attention_plain``, the same function in plain PyTorch.

Decode attention is bounded by bytes: each request's K/V rows are read
once and shared by the query heads of their kv head. The kernel splits each
request's tokens over many CTAs and merges their partial softmaxes
(``paged_attention_split_plain`` is that algorithm in plain PyTorch).

Its multi-query mode (q [B,S,H,D], ``q_pos`` [B,S], any S >= 1) serves
the per-row-start extend of the speculative verify and the draft's lead,
which the reference attends with pure-jnp ``simple_sdpa``: each CTA reads
its K/V chunk once for up to 64 of the S * G query rows of its kv head
(more rows take more row-tile CTAs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, needs_grad, plain_device
from repro_torch.kernels.ref import (NEG_INF, multi_query_rows,
                                     paged_attention_ref, paged_key_mask)

HEAD_DIMS = (32, 64, 128, 192)
#: query heads per kv head the kernel takes (granite-34b's MQA has 48)
MAX_GROUP = 64
#: Tokens the kernel stages per cp.async chunk, and the tokens of each CTA
#: of its FMA split kernel: one chunk at every batch (the source's header
#: says why).
CHUNK = 32
#: Tokens of each CTA in the multi-query mode with S >= 2 (its tensor-core
#: kernel): two chunks. S = 1 takes the one-query mode's split, so it
#: gives the one-query kernel's bits.
MQ_SPLIT = 2 * CHUNK
#: Query heads per kv head up to which bf16 one-query calls at D <= 128
#: keep the FMA kernel (the main path's G 6 among them).
FMA_GROUP = 16
#: Tokens of each CTA of the tensor-core kernel with one query a request
#: (bf16 at G > FMA_GROUP or D 192), by head dim: swept at G 48 (D 128) and
#: at D 192 (G 12), batches 4 and 8, one-query and masked
#: (``chip_smoke.py --paged-split-sweep``; PERF.md); D 32 and 64 take D
#: 128's.
TC_SPLIT = {32: 64, 64: 64, 128: 64, 192: 128}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype, g: int, d: int, s: int = 0) -> str:
    """The kernel that takes a call of ``s`` query tokens a request (0:
    the one-query and masked modes) at ``g`` query heads a kv head and head
    dim ``d`` on the card: "mma" (the tensor-core kernel, ``mma.sync``) for
    bf16 multi-query with S >= 2 and bf16 at G > FMA_GROUP or D 192 with
    one query a request, else "fma" (the FMA kernel). The wrapper passes
    it to the C entry."""
    if dtype == torch.bfloat16 and (s >= 2 or g > FMA_GROUP or d == 192):
        return "mma"
    return "fma"


def split_tokens(dtype, g: int, d: int, s: int = 0) -> int:
    """Tokens of each CTA of the split kernel for a call of ``s`` query
    tokens a request (0: the one-query and masked modes) at ``g`` query
    heads a kv head and head dim ``d``: MQ_SPLIT with S >= 2, TC_SPLIT[d]
    where one query a request takes the tensor-core kernel, else CHUNK. A
    function of the shape alone, never of seq_lens, so the grid and the
    bits of a call follow from its shape."""
    if s >= 2:
        return MQ_SPLIT
    return TC_SPLIT[d] if route(dtype, g, d, s) == "mma" else CHUNK


#: The kernel's function in plain PyTorch: it visits every page, so a
#: request with seq_len 0 gets the mean of V over its table, as the kernel.
paged_attention_plain = paged_attention_ref


def paged_attention_split_plain(q, k_pages, v_pages, block_table, seq_lens,
                                split_tokens: int, *, k_pos=None,
                                q_pos=None, window: int = 0):
    """The kernel's algorithm in plain PyTorch: each run of
    ``split_tokens`` tokens gives a partial (m, l, acc) with the kernel's
    masks (``paged_key_mask``: read tokens that are not keys score the
    -1e30 sentinel; a split past the read tokens is empty: m = -inf,
    l = 0), and the partials merge as
    sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s. Same arguments and
    result as ``paged_attention_plain``, the multi-query mode included."""
    if q.ndim == 4:
        rows = multi_query_rows(q, block_table, seq_lens, q_pos)
        return _split_plain(rows[0], k_pages, v_pages, *rows[1:3],
                            split_tokens, q_pos=rows[3], causal=True
                            ).reshape(q.shape)
    return _split_plain(q, k_pages, v_pages, block_table, seq_lens,
                        split_tokens, k_pos=k_pos, q_pos=q_pos, window=window)


def _split_plain(q, k_pages, v_pages, block_table, seq_lens,
                 split_tokens: int, *, k_pos=None, q_pos=None,
                 window: int = 0, causal: bool = False):
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    g = h // kvh
    n_tok = block_table.shape[1] * page
    n_split = -(-n_tok // split_tokens)
    pad = n_split * split_tokens - n_tok
    bt = block_table.long()
    k_log = k_pages[bt].reshape(b, n_tok, kvh, d).float()
    v_log = v_pages[bt].reshape(b, n_tok, kvh, d).float()
    qf = q.reshape(b, kvh, g, d).float() / (d ** 0.5)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_log)
    read, key = paged_key_mask(seq_lens, block_table, page, k_pos=k_pos,
                               q_pos=q_pos, window=window, causal=causal)
    s = torch.where(key[:, None, None], s, torch.full_like(s, NEG_INF))
    s = torch.where(read[:, None, None], s, torch.full_like(s, -torch.inf))
    s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
    v_log = torch.nn.functional.pad(v_log, (0, 0, 0, 0, 0, pad))
    s = s.reshape(b, kvh, g, n_split, split_tokens)
    m = s.amax(-1)                                          # [B,K,G,S]
    empty = m == -torch.inf
    p = torch.exp(s - torch.where(empty, 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgst,bstkd->bkgsd", p,
                       v_log.reshape(b, n_split, split_tokens, kvh, d))
    m_max = m.amax(-1, keepdim=True)
    w = torch.where(empty, 0.0, torch.exp(m - m_max))
    out = (w[..., None] * acc).sum(-2) / torch.clamp(
        (w * l).sum(-1), min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def _lib():
    fn = build.load("paged_attention").paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                    k_pos=None, q_pos=None, window: int = 0):
    """q [B,H,D]; k/v pages [P,page,KVH,D]; block_table [B,pages_per_seq]
    int32 with entries in [0, P); seq_lens [B] int32 -> [B,H,D].

    Masked mode (windowed and compacted caches): ``k_pos`` [P,page] int32,
    the position of each physical slot (-1 = empty); ``q_pos`` [B] int32,
    the query's position (needed with ``k_pos`` or ``window``); ``window``
    > 0, a sliding window. Token t of request b is a key iff
    t < seq_lens[b], 0 <= k_pos[t] <= q_pos[b] where ``k_pos`` is given,
    and p_t > q_pos[b] - window where ``window`` > 0 (p_t = k_pos[t] if
    given, else t); ``ref.paged_key_mask`` is the rule in plain PyTorch.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel
    (float32 or bfloat16, D in {32, 64, 128, 192}, H/KVH <= 64,
    contiguous) or raises, as it does when autograd would record the call
    (the kernel has no backward). The table's entries are not range-checked on the card (that
    would synchronize every step); the caller builds them.

    Multi-query mode: q [B,S,H,D] and ``q_pos`` [B,S] int32, no ``k_pos``
    and no window -> [B,S,H,D]; token t is a key of query i iff
    t < seq_lens[b] and t <= q_pos[b, i]. The kernel takes any S >= 1:
    a CTA holds up to 64 of a kv head's S * H / KVH query rows, and more
    rows take more CTAs.
    """
    multi = q.ndim == 4
    if multi and (k_pos is not None or window):
        raise ValueError("paged_attention: the multi-query mode takes no "
                         "k_pos and no window")
    if multi and (q_pos is None or tuple(q_pos.shape) != tuple(q.shape[:2])):
        raise ValueError(f"paged_attention: multi-query q_pos must be "
                         f"{list(q.shape[:2])}, got "
                         f"{None if q_pos is None else list(q_pos.shape)}")
    if plain_device(q):
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     seq_lens, k_pos=k_pos, q_pos=q_pos,
                                     window=window)
    if needs_grad(q, k_pages, v_pages):
        raise NotImplementedError(
            "paged_attention kernel has no backward: it serves decode, which "
            "is never differentiated (as in the reference); run under "
            "torch.no_grad() or train through flash_attention")
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if multi:
        return _multi_query(q, k_pages, v_pages, block_table, seq_lens, q_pos)
    b = q.shape[0]
    ints = [("block_table", block_table, tuple(block_table.shape)),
            ("seq_lens", seq_lens, (b,))]
    if window < 0:
        raise ValueError(f"paged_attention: window must be >= 0, got {window}")
    if k_pos is not None:
        ints.append(("k_pos", k_pos, tuple(k_pages.shape[:2])))
    if k_pos is not None or window:
        if q_pos is None:
            raise ValueError("paged_attention: k_pos or window needs q_pos")
        ints.append(("q_pos", q_pos, (b,)))
    _check_kernel_inputs(q, k_pages, v_pages, ints)
    out = _launch(q, k_pages, v_pages, block_table, seq_lens,
                  split_tokens(q.dtype, q.shape[1] // k_pages.shape[2],
                               q.shape[2]),
                  k_pos=k_pos, q_pos=q_pos if (k_pos is not None or window)
                  else None, window=window)
    paged_attention.launches += 1     # the split and merge kernels: one call
    return out


def _check_kernel_inputs(q, k_pages, v_pages, ints):
    """What the kernel takes, for a query [B, (S,) H, D]: ``ints`` lists
    (name, tensor, shape) of the int32 arguments, the block table first."""
    h, d = q.shape[-2:]
    kvh = k_pages.shape[2]
    table = ints[0][1]
    pps = table.shape[1]
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d or h % kvh \
            or table.shape[0] != q.shape[0]:
        raise ValueError(f"paged_attention kernel: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, table "
                         f"{tuple(table.shape)} do not fit")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"paged_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    for name, t, shape in ints:
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head dim "
                         f"{HEAD_DIMS}, not {d}")
    if h // kvh > MAX_GROUP:
        raise ValueError(f"paged_attention kernel takes at most {MAX_GROUP} "
                         f"query heads per kv head, not {h // kvh}")
    if pps == 0:
        raise ValueError("paged_attention kernel needs pages_per_seq >= 1")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages)) \
            or not all(t.is_contiguous() for _, t, _ in ints) \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel needs contiguous inputs and "
                         "16-byte aligned pages")


def _multi_query(q, k_pages, v_pages, block_table, seq_lens, q_pos):
    """The multi-query mode on the card: checks, then one launch."""
    b, sq, h, _ = q.shape
    _check_kernel_inputs(q, k_pages, v_pages, [
        ("block_table", block_table, tuple(block_table.shape)),
        ("seq_lens", seq_lens, (b,)), ("q_pos", q_pos, (b, sq))])
    if sq < 1:
        raise ValueError("paged_attention kernel needs S >= 1 query tokens")
    out = _launch(q, k_pages, v_pages, block_table, seq_lens,
                  split_tokens(q.dtype, h // k_pages.shape[2], q.shape[3],
                               sq), q_pos=q_pos)
    paged_attention.launches += 1
    paged_attention.multi_query_launches += 1
    return out


#: every launch of the wrapper, and those of its multi-query mode
paged_attention.launches = 0
paged_attention.multi_query_launches = 0


def _launch(q, k_pages, v_pages, block_table, seq_lens, split: int, *,
            k_pos=None, q_pos=None, window: int = 0,
            kernel: str | None = None):
    """The C entry on inputs ``paged_attention`` has checked, with
    ``split`` tokens per CTA of the split kernel (any value >= 1; more
    than ``CHUNK`` runs several chunks per CTA, which the card tests
    check). A q of [B,S,H,D] takes the multi-query mode (``q_pos``
    [B,S]), one of [B,H,D] the one-query kernel. ``kernel`` ("fma" or
    "mma", bf16 only) is the split kernel, by default ``route``'s choice;
    chip_smoke.py times the FMA kernel at shapes routed to tensor
    cores."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    sq = q.shape[1] if q.ndim == 4 else 0
    _, page, kvh, _ = k_pages.shape
    kernel = kernel or route(q.dtype, h // kvh, d, sq)
    if kernel not in ("fma", "mma"):
        raise ValueError(f"paged_attention: no split kernel {kernel!r}")
    pps = block_table.shape[1]
    n_split = -(-pps * page // split)
    rows = b * max(sq, 1) * h
    out = torch.empty_like(q)
    # float32 partials: acc [rows, n_split, D], then (m, l) [rows, n_split, 2]
    part = torch.empty(rows * n_split * (d + 2), dtype=torch.float32,
                       device=q.device)
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), seq_lens.data_ptr(),
                 None if k_pos is None else k_pos.data_ptr(),
                 None if q_pos is None else q_pos.data_ptr(), window,
                 out.data_ptr(), part.data_ptr(),
                 part[rows * n_split * d:].data_ptr(), b, sq, h, kvh, d, page,
                 pps, split, _DTYPES[q.dtype], int(kernel == "mma"),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
