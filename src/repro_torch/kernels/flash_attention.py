"""Tiled GQA flash attention: the prefill kernel of the port.

Replaces the Pallas TPU kernel ``flash_attention`` (``_flash_kernel``) of
``src/repro/kernels/flash_attention.py`` with a CUDA C++ kernel for
Hopper, ``csrc/flash_attention.cu`` (design and bound in its header). On a
CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor it
runs ``flash_attention_plain``, the same function in plain PyTorch.

Prefill attention is bounded by operations; the kernel visits only the key
tiles a q tile can see and runs its bfloat16 products on Hopper's tensor
cores (``wgmma``), fed by TMA. q, k and v may be strided ``[B, N, S, D]``
views (for example ``x.transpose(1, 2)`` of a ``[B, S, N, D]`` tensor): the
last dimension must be contiguous and every other stride a multiple of 16
bytes, which TMA requires.

Gradients: with grad enabled and an input that requires it, the wrapper
runs ``FlashAttentionFn``, whose forward also keeps each row's
log-sum-exp and whose backward is a second kernel,
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``; on a CPU tensor
``flash_attention_bwd_plain``). Without grad it is the single forward
launch it always was, with the same bits. The backward takes one of two
routes by dtype, ``bwd_route``: bfloat16 runs its products on the tensor
cores (``wgmma`` fed by TMA; at D 192 the dK / dV kernel splits them over
two consumer warpgroups), float32 on float32 FMAs.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, needs_grad, plain_device, sm_count
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_lse_ref,
                                     flash_attention_ref)

HEAD_DIMS = (32, 64, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims whose bfloat16 backward runs on the tensor cores: all of them
#: (at 192 a 64-key tile's float32 dK and dV do not fit one warpgroup's
#: registers, so two consumer warpgroups hold one each)
BWD_WGMMA_DIMS = (32, 64, 128, 192)
#: keys (and q rows) of the backward's tiles
BWD_TILE = 64
#: above this many q heads a kv head, the wgmma route's dV and dK products
#: take P^T and dS^T as bf16 hi + lo parts: one bf16 rounding of each,
#: summed over G x Sq terms, misses the bf16 bars at G 48
#: (tests/test_torch_flash_bwd_tiles.py)
BWD_HILO_G = 8


def resolve_offsets(sq: int, sk: int, causal: bool,
                    kv_len: Optional[int], q_offset: int) -> Tuple[int, int]:
    """(kv_len, q_offset) as the Pallas wrapper resolves them: kv_len
    defaults to Sk; causal with q_offset 0 and Sq < kv_len puts the q
    block at the end of the keys (``flash_attention.py:100``)."""
    kv_len = sk if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    if causal and q_offset == 0 and sq < kv_len:
        q_offset = kv_len - sq
    return kv_len, q_offset


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          kv_len: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None):
    """The kernel's function in plain PyTorch (same arguments)."""
    kv_len, q_offset = resolve_offsets(q.shape[2], k.shape[2], causal,
                                       kv_len, q_offset)
    return flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                               window=window, q_offset=q_offset, scale=scale)


def flash_attention_lse_plain(q, k, *, causal: bool = True, window: int = 0,
                              kv_len: Optional[int] = None, q_offset: int = 0,
                              scale: Optional[float] = None):
    """Each row's log-sum-exp [B,H,Sq] (float32) of its scaled, masked
    scores, which the kernel's forward writes for the backward."""
    kv_len, q_offset = resolve_offsets(q.shape[2], k.shape[2], causal,
                                       kv_len, q_offset)
    return flash_attention_lse_ref(q, k, causal=causal, kv_len=kv_len,
                                   window=window, q_offset=q_offset,
                                   scale=scale)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, kv_len: Optional[int] = None,
                              q_offset: int = 0,
                              scale: Optional[float] = None):
    """The backward kernel's function in plain PyTorch: (dq, dk, dv) of
    ``flash_attention_plain`` from its output ``o``, the log-sum-exp
    ``lse`` and the output's gradient ``do``, in the closed form
    (``ref.flash_attention_bwd_ref``); dk and dv sum each kv head's G q
    heads."""
    kv_len, q_offset = resolve_offsets(q.shape[2], k.shape[2], causal,
                                       kv_len, q_offset)
    return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                   kv_len=kv_len, window=window,
                                   q_offset=q_offset, scale=scale)


def bwd_route(dtype, d: int) -> str:
    """``"wgmma"`` for bfloat16 at a head dim in ``BWD_WGMMA_DIMS``, else
    ``"fma"`` (the source's ``flash_attention_bwd_route``)."""
    return "wgmma" if dtype == torch.bfloat16 and d in BWD_WGMMA_DIMS \
        else "fma"


def bwd_splits(b: int, kvh: int, g: int, sk: int, sms: int, d: int) -> int:
    """Groups the G q heads of a kv head are cut into for the wgmma
    route's dK / dV kernel at head dim ``d`` (one CTA per batch, kv head,
    group and 64-key tile): the fewest, a divisor of G, that give a wave
    and a half of CTAs (three an SM at two an SM; at D 192, whose CTA
    fills an SM, one and a half), so the heavy causal key tiles that start
    first leave the light ones to fill in behind, else G. Each group
    beyond one adds a float32 share of dK and dV that a reduce sums in
    group order."""
    tiles = b * kvh * -(-sk // BWD_TILE)
    per_sm = 1 if d == 192 else 2
    return next((s for s in range(1, g + 1)
                 if g % s == 0 and 2 * tiles * s >= 3 * per_sm * sms), g)


def bwd_scratch_floats(route: str, b: int, h: int, kvh: int, sq: int,
                       sk: int, d: int, splits: int) -> int:
    """Float32 scratch the backward kernel needs (laid out as the source's
    ``flash_attention_bwd`` describes): fma route delta [B,H,Sq]
    (padded to 64 values) and the q heads' dK / dV shares 2 x [B,H,Sk,D];
    wgmma route lse and delta padded to whole q tiles, 2 x [B,H,Sq_pad],
    and with more than one group the groups' shares 2 x
    [B,KVH,splits,Sk,D]."""
    if route == "fma":
        return -(-b * h * sq // 64) * 64 + 2 * b * h * sk * d
    pad = -(-sq // BWD_TILE) * BWD_TILE
    return 2 * b * h * pad + (2 * b * kvh * splits * sk * d
                              if splits > 1 else 0)


def _lib():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    fn = build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _strides(name: str, t) -> list:
    """Element strides (b, head, seq) of a [B, N, S, D] view for the
    kernel, or raise: the last dimension must be contiguous, the base
    16-byte aligned and each other stride a positive multiple of 16 bytes
    (a dimension of size 1 has no stride that matters; it is given one)."""
    elt = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16:
        raise ValueError(f"flash_attention kernel: {name} needs a contiguous "
                         f"last dimension and a 16-byte aligned base, got "
                         f"strides {t.stride()}")
    out = []
    for dim in range(3):
        st = t.stride(dim) if t.shape[dim] > 1 else t.shape[3]
        if st <= 0 or (st * elt) % 16:
            raise ValueError(f"flash_attention kernel: {name} stride "
                             f"{t.stride(dim)} of dim {dim} is not a positive "
                             f"multiple of 16 bytes")
        out.append(st)
    return out


def _check_kernel_inputs(q, k, v, scale) -> None:
    """What the kernels take, or raise (the forward's and the backward's
    conditions are the same)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim "
                         f"{HEAD_DIMS}, not {d}")
    if sq == 0 or sk == 0:
        raise ValueError("flash_attention kernel needs Sq, Sk >= 1")
    if scale is not None and not scale > 0:
        raise ValueError(f"flash_attention: scale must be > 0, got {scale}")


def _forward(q, k, v, *, causal, window, kv_len, q_offset, scale,
             with_lse: bool):
    """One launch of the forward kernel on checked inputs: (out, lse or
    None)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)          # q's strides when q is dense
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    strides = [x for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
               for x in _strides(name, t)]
    kv_len, q_offset = resolve_offsets(sq, sk, causal, kv_len, q_offset)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, h, kvh, sq, sk, d, kv_len, q_offset, int(causal),
                 int(window), 0.0 if scale is None else float(scale),
                 _DTYPES[q.dtype],
                 (ctypes.c_longlong * 12)(*strides),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None):
    """q [B,H,Sq,D]; k, v [B,KVH,Sk,D] -> [B,H,Sq,D] in q's dtype.

    ``kv_len`` marks the valid keys (default Sk); ``q_offset`` is the
    absolute position of q[..., 0, :] for the causal and window masks,
    with the Pallas wrapper's default. ``scale`` is the softmax scale;
    None keeps 1/sqrt(D), bit for bit as before the argument existed (MLA
    pads q and k with zero columns and passes the unpadded width's
    scale). A CPU tensor takes the plain
    version; a CUDA tensor takes the kernel (float32 or bfloat16, D in
    {32, 64, 128, 192}, views with a contiguous last dimension and other strides
    that are multiples of 16 bytes) or raises. The result has q's strides
    when q is a dense view, so ``flash_attention(q.transpose(1, 2), ...)``
    transposes back to a contiguous tensor. With grad enabled and an input
    that requires grad, the call goes through ``FlashAttentionFn`` (on
    either device), so q, k and v get their gradients.
    """
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset,
              scale=scale)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, kv_len,
                                      q_offset, scale)
    if plain_device(q):
        return flash_attention_plain(q, k, v, **kw)
    _check_kernel_inputs(q, k, v, scale)
    return _forward(q, k, v, with_lse=False, **kw)[0]


flash_attention.launches = 0


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None):
    """(out, lse): ``flash_attention``'s output and each row's log-sum-exp
    [B,H,Sq] float32, what the backward needs. A CUDA tensor takes one
    launch of the forward kernel with its lse epilogue (the output's bits
    are those of ``flash_attention``), a CPU tensor the plain versions.
    Not differentiable itself: ``flash_attention`` is."""
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset,
              scale=scale)
    if plain_device(q):
        return (flash_attention_plain(q, k, v, **kw),
                flash_attention_lse_plain(q, k, **kw))
    _check_kernel_inputs(q, k, v, scale)
    return _forward(q, k, v, with_lse=True, **kw)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, kv_len: Optional[int] = None,
                        q_offset: int = 0, scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) given its output
    ``o``, the forward's log-sum-exp ``lse`` [B,H,Sq] float32 and the
    output's gradient ``do`` [B,H,Sq,D]. A CPU tensor takes
    ``flash_attention_bwd_plain``; a CUDA tensor takes the backward kernel
    on its ``bwd_route`` (what the forward takes; ``do`` is copied when
    its strides do not fit) or raises. dq has q's strides, dk and dv k's
    and v's where those are dense. The result does not depend on the
    launch: two calls on the same inputs give the same bits."""
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset,
              scale=scale)
    if plain_device(q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    _check_kernel_inputs(q, k, v, scale)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"float32 [{b}, {h}, {sq}] on {q.device}")
    try:
        _strides("do", do)
    except ValueError:
        do = do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    route = bwd_route(q.dtype, d)
    splits = bwd_splits(b, kvh, h // kvh, sk, sm_count(q.device), d) \
        if route == "wgmma" else 1
    scratch = torch.empty(bwd_scratch_floats(route, b, h, kvh, sq, sk, d,
                                             splits),
                          dtype=torch.float32, device=q.device)
    strides = [x for name, t in (("q", q), ("k", k), ("v", v), ("o", o),
                                 ("do", do), ("dq", dq), ("dk", dk),
                                 ("dv", dv))
               for x in _strides(name, t)]
    kv_len, q_offset = resolve_offsets(sq, sk, causal, kv_len, q_offset)
    err = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                     b, h, kvh, sq, sk, d, kv_len, q_offset, int(causal),
                     int(window), 0.0 if scale is None else float(scale),
                     _DTYPES[q.dtype], (ctypes.c_longlong * 24)(*strides),
                     splits, int(h // kvh > BWD_HILO_G),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernel also
    writes each row's log-sum-exp, and the backward runs the backward
    kernel (plain versions of both on CPU tensors). Gradients flow to q,
    k and v only; the int and float arguments have none."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, q_offset, scale):
        kw = dict(causal=causal, window=window, kv_len=kv_len,
                  q_offset=q_offset, scale=scale)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
