"""Absorbed MLA attention: the latent decode kernel of the port.

Replaces the jnp einsums of the reference's ``mla_decode_attention``
(``src/repro/models/attention.py:503-546``; the reference has no Pallas
kernel for it) with a CUDA C++ kernel for Hopper,
``csrc/mla_attention.cu`` (design and bound in its header). On a CUDA
tensor the wrapper launches that kernel or raises; on a CPU tensor it runs
``mla_attention_plain``, the same function in plain PyTorch.

All the query heads attend to one latent stream: keys are ``ckv`` beside
``k_rope`` (576 wide at deepseek-v3's widths), values are ``ckv`` itself,
and q, the scores, the softmax and the output are float32. Two routes:

* ``"wgmma"``, a bfloat16 cache at deepseek-v3's widths (``TC_SHAPE``):
  TMA loads and bf16 tensor-core products, with q_lat and the
  probabilities each split into a bf16 high part and a bf16 remainder so
  that the products keep float32's accuracy (the source's header says
  why). Rows (query, head) of one request go in tiles of 64; ``tc_split``
  picks how many keys each CTA of a tile takes.
* ``"fma"``, the float32 cache and the smoke widths: float32 FMAs over
  ``SPLIT`` keys a CTA.

Both split the keys over CTAs and merge their partial softmaxes, as the
paged kernel does. Sq >= 1 query tokens per request serve decode (Sq = 1)
and the per-row-start verify (Sq = gamma + 1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, needs_grad, plain_device, sm_count
from repro_torch.kernels.ref import mla_attention_ref

#: (kv_lora_rank, qk_rope_head_dim) pairs the kernel is instantiated for:
#: deepseek-v3's smoke config and its published widths
SHAPES = ((32, 16), (512, 64))
#: keys of each CTA of the FMA route's split kernel
SPLIT = 128
#: (kv_lora_rank, qk_rope_head_dim) of the tensor-core route (bf16 cache)
TC_SHAPE = (512, 64)
#: rows (query, head) and keys of one tensor-core tile
TC_ROWS, TC_KEYS = 64, 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The kernel's function in plain PyTorch.
mla_attention_plain = mla_attention_ref


def route(dtype, r: int) -> str:
    """``"wgmma"`` for a bfloat16 cache at ``TC_SHAPE``'s latent rank,
    else ``"fma"`` (the source's ``mla_attention_route``)."""
    return "wgmma" if dtype == torch.bfloat16 and r == TC_SHAPE[0] \
        else "fma"


def tc_split(b: int, sq: int, h: int, length: int, sms: int) -> int:
    """Keys each CTA of the tensor-core route takes, a whole number of
    key tiles: enough CTAs per row tile that row tiles x CTAs roughly
    fills the ``sms`` SMs, with at least one key tile a CTA."""
    tiles = b * -(-sq * h // TC_ROWS)
    key_tiles = -(-length // TC_KEYS)
    n = min(key_tiles, max(1, sms // tiles))
    return TC_KEYS * -(-key_tiles // n)


def _lib():
    fn = build.load("mla_attention").mla_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mla_attention(q_lat, q_rope, ckv, k_rope, q_pos, *, k_pos=None,
                  window: int = 0, scale: float):
    """q_lat [B,Sq,H,R] and q_rope [B,Sq,H,Rr] float32; ckv [B,L,R] and
    k_rope [B,L,Rr] (bfloat16 or float32); q_pos [B,Sq] int32 ->
    o_lat [B,Sq,H,R] float32.

    Key t is valid for query i of row b iff 0 <= p_t <= q_pos[b, i], and
    p_t > q_pos[b, i] - window when ``window`` > 0, where p_t is
    ``k_pos[b, t]`` ([B,L] int32, a windowed cache's ``slot_pos``) when
    given, else t (``ref.mla_key_mask``). Scores are
    ``(q_lat . ckv + q_rope . k_rope) * scale``.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel
    ((R, Rr) in ``SHAPES``, contiguous, 16-byte aligned) or raises, as it
    does when autograd would record the call (the kernel has no backward).
    """
    if plain_device(q_lat):
        return mla_attention_plain(q_lat, q_rope, ckv, k_rope, q_pos,
                                   k_pos=k_pos, window=window, scale=scale)
    if needs_grad(q_lat, q_rope, ckv, k_rope):
        raise NotImplementedError(
            "mla_attention kernel has no backward: it serves the absorbed "
            "decode, which is never differentiated (as in the reference); "
            "run under torch.no_grad() or train through the naive form on "
            "flash_attention")
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_attention: unsupported device {q_lat.device}")
    b, sq, h, r = q_lat.shape
    length, rr = ckv.shape[1], k_rope.shape[2]
    shapes = {"q_rope": (q_rope, (b, sq, h, rr), torch.float32),
              "ckv": (ckv, (b, length, r), ckv.dtype),
              "k_rope": (k_rope, (b, length, rr), ckv.dtype),
              "q_pos": (q_pos, (b, sq), torch.int32)}
    if k_pos is not None:
        shapes["k_pos"] = (k_pos, (b, length), torch.int32)
    if q_lat.dtype != torch.float32:
        raise ValueError(f"mla_attention: q_lat must be float32, not "
                         f"{q_lat.dtype}")
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != q_lat.device:
            raise ValueError(f"mla_attention kernel: {name} must be "
                             f"{list(shape)} {dtype} on {q_lat.device}, got "
                             f"{list(t.shape)} {t.dtype} on {t.device}")
    if ckv.dtype not in _DTYPES:
        raise ValueError(f"mla_attention kernel takes a float32 or bfloat16 "
                         f"cache, not {ckv.dtype}")
    if (r, rr) not in SHAPES:
        raise ValueError(f"mla_attention kernel takes (R, Rr) in {SHAPES}, "
                         f"not {(r, rr)}")
    if sq < 1 or length < 1 or window < 0:
        raise ValueError(f"mla_attention kernel needs Sq, L >= 1 and window "
                         f">= 0, got {sq}, {length}, {window}")
    tensors = [q_lat, q_rope, ckv, k_rope, q_pos] + \
        ([] if k_pos is None else [k_pos])
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("mla_attention kernel needs contiguous, 16-byte "
                         "aligned inputs")
    split = tc_split(b, sq, h, length, sm_count(q_lat.device)) \
        if route(ckv.dtype, r) == "wgmma" else SPLIT
    out = _launch(q_lat, q_rope, ckv, k_rope, q_pos, k_pos, window, scale,
                  split)
    mla_attention.launches += 1
    return out


def _launch(q_lat, q_rope, ckv, k_rope, q_pos, k_pos, window: int,
            scale: float, split: int):
    """The C entry on inputs ``mla_attention`` has checked, with ``split``
    keys per CTA (a multiple of ``TC_KEYS`` on the tensor-core route)."""
    b, sq, h, r = q_lat.shape
    length, rr = ckv.shape[1], k_rope.shape[2]
    n_split = -(-length // split)
    rows = b * sq * h
    out = torch.empty((b, sq, h, r), dtype=torch.float32,
                      device=q_lat.device)
    # float32 partials: acc [rows, n_split, R], then (m, l) [rows, n_split, 2]
    # (the tensor-core route writes none with one split)
    tc = route(ckv.dtype, r) == "wgmma"
    n_part = 0 if tc and n_split == 1 else rows * n_split * (r + 2)
    part = torch.empty(n_part, dtype=torch.float32, device=q_lat.device)
    err = _lib()(q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
                 k_rope.data_ptr(), q_pos.data_ptr(),
                 None if k_pos is None else k_pos.data_ptr(), int(window),
                 out.data_ptr(), part.data_ptr(),
                 part[rows * n_split * r:].data_ptr(), b, sq, h, length, r,
                 rr, split, float(scale), _DTYPES[ckv.dtype],
                 torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err:
        raise RuntimeError(f"mla_attention kernel launch failed: CUDA error "
                           f"{err}")
    return out


mla_attention.launches = 0
