"""Functional layer library: ParamSpec trees + plain functions on tensors.

Port of ``repro.models.layers``. Params are nested dicts of tensors with
the reference's layouts (heads unfused: wq [embed, heads, head_dim], and
so on), so a reference parameter tree carries over key for key
(``repro_torch.models.convert``).

The reference's einsums accumulate in float32 (``preferred_element_type``)
and cast back. Here a matmul in float32 is the same; in bfloat16 PyTorch
accumulates in float32 inside the product but rounds its output to
bfloat16 before the float32 epilogues (SwiGLU, logits).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev for normal
    dtype: Optional[str] = None   # override model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec(shape, axes, init="normal", scale=None, dtype=None) -> ParamSpec:
    if scale is None:
        # default fan-in init: 1/sqrt(first contracted dim)
        scale = 1.0 / max(1.0, float(shape[0])) ** 0.5 if init == "normal" else 1.0
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def tree_map_specs(fn, tree, path=()):
    """Map ``fn(path, spec)`` over a nested dict of ParamSpec."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def init_params(specs, seed: int, default_dtype: str, device):
    """Materialize a param tree from a spec tree.

    Each leaf draws from its own ``torch.Generator`` seeded from ``seed``
    and the crc32 of its path, so a leaf's values do not depend on the
    order of the walk. The draws are not the reference's ``jax.random``
    numbers; the fan-in scales are the same.
    """
    device = torch.device(device)

    def _one(path, s: ParamSpec):
        dt = DTYPES[s.dtype or default_dtype]
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + zlib.crc32("/".join(path).encode()))
        w = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * s.scale).to(dt)
    return tree_map_specs(_one, specs)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_specs(cfg) -> Dict[str, ParamSpec]:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.norm} is not ported yet (ROADMAP queue A, slice 7)")
    return {"scale": spec((cfg.d_model,), ("embed",), init="ones")}


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    """RMSNorm (the only norm of the ported families)."""
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"{kind} is not ported yet (ROADMAP queue A, slice 7)")
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def embed_specs(cfg) -> Dict[str, ParamSpec]:
    out = {"tok": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                       scale=0.02)}
    if not cfg.tie_embeddings:
        out["unembed"] = spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return out


def embed_tokens(p, tokens):
    return p["tok"][tokens]


def unembed(p, x, softcap: float = 0.0):
    w = p["unembed"] if "unembed" in p else p["tok"].t()
    logits = torch.matmul(x, w).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# --------------------------------------------------------------------------
# rotary embeddings (RoPE and Qwen2-VL M-RoPE)
# --------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [..., S] -> cos,sin [..., S, head_dim//2] (float32)."""
    freqs = torch.as_tensor(_rope_freqs(head_dim, theta), dtype=torch.float32,
                            device=positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def mrope_cos_sin(positions_thw, head_dim: int, theta: float, sections):
    """Qwen2-VL multimodal RoPE.

    positions_thw: [3, B, S] (temporal, height, width position ids).
    ``sections`` split head_dim//2 frequency pairs into (t, h, w) groups;
    each group takes its angle from the corresponding position stream.
    """
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} vs head_dim {head_dim}")
    freqs = torch.as_tensor(_rope_freqs(head_dim, theta), dtype=torch.float32,
                            device=positions_thw.device)
    cos_t, sin_t = [], []
    start = 0
    for i, sec in enumerate(sections):
        ang = positions_thw[i].float()[..., None] * freqs[start:start + sec]
        cos_t.append(torch.cos(ang))
        sin_t.append(torch.sin(ang))
        start += sec
    return torch.cat(cos_t, -1), torch.cat(sin_t, -1)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin [..., S, D//2] broadcast over heads
    (split-halves convention, as the reference)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------

def mlp_specs(cfg) -> Dict[str, ParamSpec]:
    if cfg.activation != "swiglu" or cfg.weight_quant != "none":
        raise NotImplementedError(
            f"{cfg.activation} / {cfg.weight_quant} FFNs are not ported yet "
            "(ROADMAP queue A, slice 7)")
    d, d_ff = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": spec((d, d_ff), ("embed", "ffn")),
        "wi_up": spec((d, d_ff), ("embed", "ffn")),
        "wo": spec((d_ff, d), ("ffn", "embed")),
    }


def apply_mlp(p, x, activation: str):
    """SwiGLU: silu(x Wg) * (x Wu) in float32, back to x's dtype, then Wo."""
    if activation != "swiglu":
        raise NotImplementedError(
            f"{activation} is not ported yet (ROADMAP queue A, slice 7)")
    h = F.silu(torch.matmul(x, p["wi_gate"]).float()) \
        * torch.matmul(x, p["wi_up"]).float()
    return torch.matmul(h.to(x.dtype), p["wo"]).to(x.dtype)
