"""Perceiver resampler (survey dim 3a: cross-modal projector/resampler).

Port of ``repro.models.resampler``. Flamingo's design: a set of learned
latent queries cross-attends to the (variable-length) visual patch stream
and emits a FIXED number of visual tokens, whatever the input
resolution. Selected on VLM configs by ``projector="perceiver"``.

The reference computes the block in jnp einsums, not a Pallas kernel, so
plain PyTorch on the card is its port: the projections, scores, softmax
and products run in float32 (the reference's ``preferred_element_type``)
and the residual stream stays in the patches' dtype.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, spec
from repro_torch.sharding.context import einsum, matmul


def resampler_specs(cfg, num_latents: int = 64,
                    num_heads: int = 8) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    hd = d // num_heads
    return {
        "latents": spec((num_latents, d), (None, "embed"), scale=0.02),
        "wq": spec((d, num_heads, hd), ("embed", "heads", None)),
        "wk": spec((d, num_heads, hd), ("embed", "heads", None)),
        "wv": spec((d, num_heads, hd), ("embed", "heads", None)),
        "wo": spec((num_heads, hd, d), ("heads", None, "embed")),
        "ln_q": spec((d,), ("embed",), init="ones"),
        "ln_kv": spec((d,), ("embed",), init="ones"),
        "mlp_wi": spec((d, 4 * d), ("embed", "ffn")),
        "mlp_wo": spec((4 * d, d), ("ffn", "embed")),
    }


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _f32_mm(x, w):
    """x @ w in float32 (w's leading dim contracted, the rest kept)."""
    return matmul(x.float(), w.float().reshape(w.shape[0], -1)
                  ).reshape(x.shape[:-1] + w.shape[1:])


def apply_resampler(p, patches) -> torch.Tensor:
    """patches [B, N, d] (any N) -> [B, num_latents, d].

    One cross-attention block (latents query the patches) and an MLP,
    with a residual around both, as the reference.
    """
    b = patches.shape[0]
    lat = p["latents"][None].expand((b,) + tuple(p["latents"].shape)
                                    ).to(patches.dtype)
    q_in = _rms(lat, p["ln_q"])
    kv_in = _rms(patches, p["ln_kv"])
    hd = p["wq"].shape[2]
    q = _f32_mm(q_in, p["wq"])                       # [B,L,H,hd]
    k = _f32_mm(kv_in, p["wk"])                      # [B,N,H,hd]
    v = _f32_mm(kv_in, p["wv"])
    s = einsum("blhe,bnhe->bhln", q, k) / (hd ** 0.5)
    a = torch.softmax(s, -1)
    o = einsum("bhln,bnhe->blhe", a, v)
    lat = lat + matmul(o.reshape(o.shape[0], o.shape[1], -1),
                       p["wo"].float().reshape(-1, p["wo"].shape[-1])
                       ).to(patches.dtype)
    h = _f32_mm(_rms(lat, p["ln_q"]), p["mlp_wi"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh").to(patches.dtype)
    return lat + _f32_mm(h, p["mlp_wo"]).to(patches.dtype)
