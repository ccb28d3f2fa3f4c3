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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _lib():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
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
    transposes back to a contiguous tensor.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len, q_offset=q_offset,
                                     scale=scale)
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
    out = torch.empty_like(q)          # q's strides when q is dense
    strides = [x for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
               for x in _strides(name, t)]
    kv_len, q_offset = resolve_offsets(sq, sk, causal, kv_len, q_offset)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, kvh, sq, sk, d, kv_len, q_offset, int(causal),
                 int(window), 0.0 if scale is None else float(scale),
                 _DTYPES[q.dtype],
                 (ctypes.c_longlong * 12)(*strides),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
