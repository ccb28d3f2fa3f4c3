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

# the reference's ``layers.constrain_replicated`` (weight-stationary decode)
from repro_torch.sharding.context import constrain_replicated  # noqa: F401
from repro_torch.sharding.context import lookup, matmul

# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "int8": torch.int8}


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
    numbers; the fan-in scales are the same, and int8 leaves (quantized
    FFN weights) draw integers in [-64, 64] as the reference's.
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
        if dt == torch.int8:
            return torch.randint(-64, 65, s.shape, generator=gen,
                                 dtype=torch.int8, device=device)
        w = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(s.scale).to(dt)
    return tree_map_specs(_one, specs)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_specs(cfg, with_bias: Optional[bool] = None) -> Dict[str, ParamSpec]:
    use_bias = cfg.norm == "layernorm" if with_bias is None else with_bias
    out = {"scale": spec((cfg.d_model,), ("embed",), init="ones")}
    if use_bias:
        out["bias"] = spec((cfg.d_model,), ("embed",), init="zeros")
    return out


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    """RMSNorm, or LayerNorm with the population variance (``jnp.var``),
    in float32; a ``bias`` leaf is added when present."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def quantize_ffn_params(params):
    """Post-training int8 quantization of FFN weights (per output
    channel), the reference's ``quantize_ffn_params``: every MLP dict
    ({wi | wi_gate, wi_up}, wo) gets int8 weights and float32 ``<name>_s``
    scales, the ``weight_quant='int8_ffn'`` layout. Stacked leading dims
    are kept (the max is over the input dim only). Returns a new tree."""
    def quant(w):
        wf = w.float()
        scale = torch.clamp(wf.abs().amax(-2, keepdim=True) / 127.0,
                            min=1e-8)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return q, scale.squeeze(-2)

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "wo" in node and ("wi" in node or "wi_gate" in node) \
                and not any(k.endswith("_s") for k in node):
            out = dict(node)
            for k in ("wi", "wi_gate", "wi_up", "wo"):
                if k in node:
                    out[k], out[k + "_s"] = quant(node[k])
            return out
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


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
    """The rows of ``tokens`` (under a mesh, ``sharding.context.lookup``)."""
    return lookup(p["tok"], tokens)


def unembed(p, x, softcap: float = 0.0):
    w = p["unembed"] if "unembed" in p else p["tok"].t()
    logits = matmul(x, w).float()
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
# MLPs (SwiGLU / squared-ReLU / GELU, optionally int8 weights)
# --------------------------------------------------------------------------

def mlp_specs(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    quant = cfg.weight_quant == "int8_ffn"
    wdt = "int8" if quant else None
    names = ("wi_gate", "wi_up") if cfg.activation == "swiglu" else ("wi",)
    out = {n: spec((d, d_ff), ("embed", "ffn"), dtype=wdt) for n in names}
    out["wo"] = spec((d_ff, d), ("ffn", "embed"), dtype=wdt)
    if quant:
        for n in names:
            out[n + "_s"] = spec((d_ff,), ("ffn",), init="ones",
                                 dtype="float32")
        out["wo_s"] = spec((d,), ("embed",), init="ones", dtype="float32")
    return out


def _qmm(x, w, scale):
    """x @ int8 w with the per-output-channel scale applied after the
    product (float32), as the reference's ``_qmm``."""
    return matmul(x, w.to(x.dtype)).float() * scale.float()


def _mm(p, x, name: str):
    """x @ p[name] in float32 (dequantized when p holds ``<name>_s``)."""
    if name + "_s" in p:
        return _qmm(x, p[name], p[name + "_s"])
    return matmul(x, p[name]).float()


def apply_mlp(p, x, activation: str):
    """SwiGLU silu(x Wg) * (x Wu), or act(x Wi) for ``relu2`` (squared
    ReLU) and ``gelu`` (tanh approximation, ``jax.nn.gelu``'s default),
    in float32, back to x's dtype, then Wo."""
    if activation == "swiglu":
        h = F.silu(_mm(p, x, "wi_gate")) * _mm(p, x, "wi_up")
    elif activation == "relu2":
        h = torch.relu(_mm(p, x, "wi")).square()
    elif activation == "gelu":
        h = F.gelu(_mm(p, x, "wi"), approximate="tanh")
    else:
        raise ValueError(activation)
    h = h.to(x.dtype)
    if "wo_s" in p:
        return _qmm(h, p["wo"], p["wo_s"]).to(x.dtype)
    return matmul(h, p["wo"]).to(x.dtype)
