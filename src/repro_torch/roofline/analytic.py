"""Analytic (napkin-math) FLOPs / HBM-bytes model per (config x shape).

Port of ``repro.roofline.analytic``, the model-level ideal:

  * flops: 2*N_active per token (+attention quadratic term), x3 for the
    backward pass, +1 forward for full remat;
  * bytes: the dominant steady-state HBM traffic -- weights read once per
    step, KV cache read per decode token, optimizer state read+written per
    train step, activations for the non-remat case.

It keeps the reference's rules, ``active_param_count`` quirk included
(ROADMAP C5), so the two packages give the same numbers.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig

_DT = {"bfloat16": 2, "float32": 4, "float16": 2}


def _attn_flops(cfg: ModelConfig, batch: int, q_len: int, kv_len: int,
                causal: bool) -> float:
    """QK^T + PV einsum flops across layers (grouped query)."""
    if cfg.is_attention_free:
        return 0.0
    hd = cfg.head_dim
    h = cfg.num_heads
    layers = cfg.num_layers
    if cfg.family == "hybrid" and cfg.attn_layer_period:
        layers = cfg.num_layers // cfg.attn_layer_period
        kv_len = min(kv_len, cfg.sliding_window or kv_len)
    if cfg.sliding_window:
        kv_len = min(kv_len, cfg.sliding_window)
    per_layer = 4.0 * batch * q_len * kv_len * h * hd
    if causal and q_len == kv_len:
        per_layer *= 0.5
    total = per_layer * layers
    if cfg.family == "audio":
        # + cross attention over encoder_seq + encoder self-attention
        total += 4.0 * batch * q_len * cfg.encoder_seq * h * hd * layers
        total += (4.0 * batch * cfg.encoder_seq ** 2 * h * hd
                  * cfg.encoder_layers)
    return total


def flops_estimate(cfg: ModelConfig, sc: ShapeConfig) -> float:
    n_act = cfg.active_param_count()
    b, s = sc.global_batch, sc.seq_len
    if cfg.family == "audio":
        s = min(s, cfg.decoder_max_seq or s)
    if sc.kind == "train":
        tokens = b * s
        fwd = 2.0 * n_act * tokens + _attn_flops(cfg, b, s, s, True)
        return 4.0 * fwd            # fwd + 2x bwd + 1x remat re-fwd
    if sc.kind == "prefill":
        tokens = b * s
        return 2.0 * n_act * tokens + _attn_flops(cfg, b, s, s, True)
    # decode: one token per request against a seq_len cache
    return 2.0 * n_act * b + _attn_flops(cfg, b, 1, s, False)


def bytes_estimate(cfg: ModelConfig, sc: ShapeConfig) -> float:
    """Steady-state HBM traffic per step (global; divide by chips)."""
    dt = _DT.get(cfg.dtype, 2)
    n = cfg.param_count()
    b, s = sc.global_batch, sc.seq_len
    if cfg.family == "audio":
        s = min(s, cfg.decoder_max_seq or s)
    weights = n * dt
    if sc.kind == "train":
        # params read + grads written + Adam mu/nu read+written (f32)
        opt = n * 4 * 2 * 2
        acts = 2.0 * b * s * cfg.d_model * cfg.num_layers * dt  # remat'd
        return weights * 2 + opt + acts
    if sc.kind == "prefill":
        cache_write = b * s * cfg.kv_head_dim * cfg.num_layers * dt
        acts = 2.0 * b * s * cfg.d_model * cfg.num_layers * dt
        return weights + cache_write + acts
    # decode: active params + full cache read per token
    n_act = cfg.active_param_count()
    kv_len = min(s, cfg.sliding_window) if cfg.sliding_window else s
    if cfg.is_attention_free:
        cache = b * cfg.num_layers * cfg.d_model * cfg.ssm_head_dim * 4
    elif cfg.family == "hybrid":
        attn_layers = cfg.num_layers // max(cfg.attn_layer_period, 1)
        cache = (b * kv_len * cfg.kv_head_dim * attn_layers * dt
                 + b * cfg.num_layers * cfg.d_model * 2 * cfg.ssm_state_dim
                 * 4 / cfg.ssm_head_dim)
    else:
        cache = b * kv_len * cfg.kv_head_dim * cfg.num_layers * dt
    return n_act * dt + cache


def summary(cfg: ModelConfig, sc: ShapeConfig) -> Dict[str, float]:
    return {"analytic_flops": flops_estimate(cfg, sc),
            "analytic_bytes": bytes_estimate(cfg, sc)}
