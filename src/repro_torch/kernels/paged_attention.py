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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, paged_attention_ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 16
#: Tokens the kernel stages per cp.async chunk, and the tokens of each CTA
#: of its split kernel: one chunk at every batch (the source's header says
#: why).
CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The kernel's function in plain PyTorch: it visits every page, so a
#: request with seq_len 0 gets the mean of V over its table, as the kernel.
paged_attention_plain = paged_attention_ref


def paged_attention_split_plain(q, k_pages, v_pages, block_table, seq_lens,
                                split_tokens: int):
    """The kernel's algorithm in plain PyTorch: each run of
    ``split_tokens`` tokens gives a partial (m, l, acc) with the kernel's
    masks (a request with seq_len > 0 reads its first seq_len tokens, one
    with seq_len 0 every slot of its table at the -1e30 sentinel; a split
    past them is empty: m = -inf, l = 0), and the partials merge as
    sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s. Same arguments and
    result as ``paged_attention_plain``."""
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
    seq = seq_lens.to(q.device).long()
    pos = torch.arange(n_tok, device=q.device)
    read = pos[None] < torch.where(seq > 0, seq, n_tok)[:, None]   # [B, T]
    s = torch.where((seq > 0)[:, None, None, None], s,
                    torch.full_like(s, NEG_INF))
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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k_pages, v_pages, block_table, seq_lens):
    """q [B,H,D]; k/v pages [P,page,KVH,D]; block_table [B,pages_per_seq]
    int32 with entries in [0, P); seq_lens [B] int32 -> [B,H,D].

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel
    (float32 or bfloat16, D in {64, 128}, H/KVH <= 16, contiguous) or
    raises. The table's entries are not range-checked on the card (that
    would synchronize every step); the caller builds them.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    pps = block_table.shape[1]
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d or h % kvh \
            or block_table.shape[0] != b:
        raise ValueError(f"paged_attention kernel: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, table "
                         f"{tuple(block_table.shape)} do not fit")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"paged_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    for name, t in (("block_table", block_table), ("seq_lens", seq_lens)):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head dim "
                         f"{HEAD_DIMS}, not {d}")
    if h // kvh > MAX_GROUP:
        raise ValueError(f"paged_attention kernel takes at most {MAX_GROUP} "
                         f"query heads per kv head, not {h // kvh}")
    if seq_lens.shape != (b,):
        raise ValueError(f"seq_lens must be [{b}], got {tuple(seq_lens.shape)}")
    if pps == 0:
        raise ValueError("paged_attention kernel needs pages_per_seq >= 1")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, block_table,
                                           seq_lens)) \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel needs contiguous inputs and "
                         "16-byte aligned pages")
    out = _launch(q, k_pages, v_pages, block_table, seq_lens, CHUNK)
    paged_attention.launches += 1     # the split and merge kernels: one call
    return out


paged_attention.launches = 0


def _launch(q, k_pages, v_pages, block_table, seq_lens, split: int):
    """The C entry on inputs ``paged_attention`` has checked, with
    ``split`` tokens per CTA of the split kernel (any value >= 1; more
    than ``CHUNK`` runs several chunks per CTA, which ``chip_smoke.py``
    times against the wrapper's one)."""
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    pps = block_table.shape[1]
    n_split = -(-pps * page // split)
    out = torch.empty_like(q)
    # float32 partials: acc [B*H, n_split, D], then (m, l) [B*H, n_split, 2]
    part = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                       device=q.device)
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                 part.data_ptr(), part[b * h * n_split * d:].data_ptr(), b, h,
                 kvh, d, page, pps, split, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
