"""RWKV-6 "Finch" block: attention-free, with a data-dependent decay.

Port of ``repro.models.rwkv`` (arXiv:2404.05892). Time-mix with a
dynamic data-dependent decay w_t and a per-head bonus u; channel-mix
with squared ReLU. The decode state is O(1): one token-shift vector per
mix and the float32 [B, H, hd, hd] wkv state per layer, and no KV cache.

The reference scans the recurrence over time with ``lax.scan``; no Pallas
kernel exists for it, so the port is a plain PyTorch loop over tokens
(``_wkv_step`` once per token), the same arithmetic as decode. On the
card that loop is launch-bound (ROADMAP queue B).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, spec
from repro_torch.sharding.context import Arg, keep_sharded, local, matmul

_LORA_R = 32   # decay-LoRA rank (the reference's scaled-down default)


def _dims(cfg):
    nheads = cfg.d_model // cfg.ssm_head_dim
    return nheads, cfg.ssm_head_dim


def rwkv_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    nheads, hd = _dims(cfg)
    tm = {
        # static token-shift lerp coefficients per stream
        "mu_r": spec((d,), ("embed",), init="zeros"),
        "mu_k": spec((d,), ("embed",), init="zeros"),
        "mu_v": spec((d,), ("embed",), init="zeros"),
        "mu_w": spec((d,), ("embed",), init="zeros"),
        "mu_g": spec((d,), ("embed",), init="zeros"),
        "w_r": spec((d, d), ("embed", "heads_flat")),
        "w_k": spec((d, d), ("embed", "heads_flat")),
        "w_v": spec((d, d), ("embed", "heads_flat")),
        "w_g": spec((d, d), ("embed", "heads_flat")),
        "w_o": spec((d, d), ("heads_flat", "embed")),
        # data-dependent decay: w_t = exp(-exp(w0 + lora(x_w)))
        "w0": spec((d,), ("embed",), init="zeros"),
        "w_lora_a": spec((d, _LORA_R), ("embed", None)),
        "w_lora_b": spec((_LORA_R, d), (None, "embed"), scale=0.01),
        "u": spec((nheads, hd), ("heads", None), init="zeros"),
        "ln_scale": spec((d,), ("embed",), init="ones"),
        "ln_bias": spec((d,), ("embed",), init="zeros"),
    }
    cm = {
        "mu_k": spec((d,), ("embed",), init="zeros"),
        "mu_r": spec((d,), ("embed",), init="zeros"),
        "w_k": spec((d, cfg.d_ff), ("embed", "ffn")),
        "w_v": spec((cfg.d_ff, d), ("ffn", "embed")),
        "w_r": spec((d, d), ("embed", "embed_out")),
    }
    return {"time_mix": tm, "channel_mix": cm}


def rwkv_cache_specs(cfg, batch: int):
    nheads, hd = _dims(cfg)
    return {
        "tm_shift": spec((batch, cfg.d_model), ("batch", "embed"),
                         init="zeros"),
        "cm_shift": spec((batch, cfg.d_model), ("batch", "embed"),
                         init="zeros"),
        "wkv": spec((batch, nheads, hd, hd), ("batch", "heads", None, None),
                    init="zeros", dtype="float32"),
    }


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _time_mix_streams(p, x, x_prev, cfg):
    """The five streams: r, k, v, g [..., H, hd] in x's dtype and the
    decay w [..., H, hd] in float32."""
    nheads, hd = _dims(cfg)
    r = matmul(_lerp(x, x_prev, p["mu_r"]), p["w_r"])
    k = matmul(_lerp(x, x_prev, p["mu_k"]), p["w_k"])
    v = matmul(_lerp(x, x_prev, p["mu_v"]), p["w_v"])
    g = matmul(_lerp(x, x_prev, p["mu_g"]), p["w_g"])
    xw = _lerp(x, x_prev, p["mu_w"])
    w_dyn = matmul(matmul(xw, p["w_lora_a"]), p["w_lora_b"])
    w = torch.exp(-torch.exp((p["w0"] + w_dyn).float()))     # (0, 1)
    shp = x.shape[:-1] + (nheads, hd)
    # under a mesh: rwkv6-3b's 40 heads do not split over a 16-wide
    # "model" axis, so the streams keep only their batch sharding
    return tuple(keep_sharded(t, (0,)).reshape(shp) for t in (r, k, v, g, w))


def _wkv_step(state, r, k, v, w, u):
    """state [B,H,hd,hd] (k-major), one token's r, k, v, w [B,H,hd] and
    the bonus u [H,hd] (float32). Returns (y [B,H,hd], new state):
    y = r (state + u kv), state' = w state + kv with kv = k v^T, in four
    launches on float32 inputs (the reference's arithmetic; ``addcmul``
    may fuse a product and a sum)."""
    kv = k.float()[..., :, None] * v.float()[..., None, :]   # [B,H,hd,hd]
    y = torch.matmul(r.float()[..., None, :],
                     torch.addcmul(state, u[..., None], kv))[..., 0, :]
    return y, torch.addcmul(kv, w[..., :, None], state)


def _wkv_scan(state, r, k, v, w, u):
    """The recurrence over the T tokens of r, k, v, w [B,T,H,hd], one
    ``_wkv_step`` each (the reference's ``lax.scan``), r, k and v cast to
    float32 once. Returns (ys [B,T,H,hd] float32, the final state)."""
    r, k, v = r.float(), k.float(), v.float()
    if r.device.type == "meta":
        # shape-only stand-ins (the dry run): the loop's products in one
        # batched matmul, the same matmul FLOPs forward and backward, with
        # no per-token dispatch
        kv = k[..., :, None] * v[..., None, :]               # [B,T,H,hd,hd]
        ys = torch.matmul(r[..., None, :], torch.addcmul(
            state[:, None], u[..., None], kv))[..., 0, :]
        return ys, torch.addcmul(kv[:, -1], w[:, -1, ..., None], state)
    ys = []
    for i in range(r.shape[1]):
        y, state = _wkv_step(state, r[:, i], k[:, i], v[:, i], w[:, i], u)
        ys.append(y)
    return torch.stack(ys, 1), state


def _group_norm(y, scale, bias, eps=1e-5):
    """Per-head LayerNorm over the last dim; y [..., H, hd]."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps) * scale + bias


def _shifted(x, shift: Optional[torch.Tensor]):
    """x [B,T,d] delayed one token; the first row is ``shift`` [B,d] (the
    previous call's last token) or zeros."""
    first = (shift[:, None].to(x.dtype) if shift is not None
             else torch.zeros_like(x[:, :1]))
    return torch.cat([first, x[:, :-1]], 1)


def time_mix_forward(p, x, cfg, state=None) -> Tuple[torch.Tensor, Dict]:
    """x [B,T,d]: the recurrence over T. ``state``: {"tm_shift", "wkv"}
    or None. Returns (out [B,T,d], {"tm_shift", "wkv"})."""
    b = x.shape[0]
    nheads, hd = _dims(cfg)
    r, k, v, g, w = _time_mix_streams(
        p, x, _shifted(x, None if state is None else state["tm_shift"]), cfg)
    s = (state["wkv"].float() if state is not None
         else torch.zeros((b, nheads, hd, hd), device=x.device))
    # the recurrence, its group norm and the gate are per (row, head):
    # under a mesh they run on each rank's local rows and heads
    ys, s = local(_wkv_out, [Arg(s, 0, 1), Arg(r, 0, 2), Arg(k, 0, 2),
                             Arg(v, 0, 2), Arg(w, 0, 2), Arg(g, 0, 2),
                             Arg(p["u"].float(), None, 0),
                             Arg(p["ln_scale"], None, 0),
                             Arg(p["ln_bias"], None, 0)],
                  [(0, 2), (0, 1)])
    out = matmul(ys.to(x.dtype), p["w_o"])
    return out, {"tm_shift": x[:, -1], "wkv": s}


def _wkv_out(s, r, k, v, w, g, u, ln_scale, ln_bias):
    """The scan over r, k, v, w [B,T,H,hd] from state s, each head's group
    norm, and the gate g: (ys [B,T,H*hd] float32, the final state)."""
    ys, s = _wkv_scan(s, r, k, v, w, u)
    heads = r.shape[-2:]
    ys = _group_norm(ys, ln_scale.reshape(heads), ln_bias.reshape(heads))
    b, t = r.shape[:2]
    return ys.reshape(b, t, -1) * F.silu(g.reshape(b, t, -1).float()), s


def channel_mix_forward(p, x, cfg, state=None) -> Tuple[torch.Tensor, Dict]:
    x_prev = _shifted(x, None if state is None else state["cm_shift"])
    k = matmul(_lerp(x, x_prev, p["mu_k"]), p["w_k"])
    k = torch.relu(k).square()
    r = torch.sigmoid(matmul(_lerp(x, x_prev, p["mu_r"]), p["w_r"]))
    return r * matmul(k, p["w_v"]), {"cm_shift": x[:, -1]}


# Layer assembly (pre-norms and residuals) lives in models/transformer.py,
# as in the reference.
