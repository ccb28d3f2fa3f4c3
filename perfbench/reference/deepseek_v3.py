"""Plain float32 reference of DeepSeek-V3 (arXiv:2412.19437) as the port
serves it, from the configuration file's own keys.

One pass over [prompt tokens | served tokens but the last], layer by
layer; the logits at the positions that predicted the served tokens.
Attention is MLA in the naive form (per-head keys and values expanded
from the normalised latent), which equals the absorbed form the program
decodes with. The expert layer keeps the serving path's rules: the
prompt's rows go through one capacity-bounded dispatch, as the program's
prefill runs them (capacity ``int(1.25 * P * k / E)`` a routed expert over
the P prompt tokens; an expert's (token, choice) pairs past it, in token
order, are dropped), the served rows dropless, as the program decodes
them. Each routed expert's weights are cast to float32 one expert at a
time, so the reference fits beside the served weights.

Departures from the published model, each the port's as well: a softmax
router over all experts, top-k renormalised, with no expert groups
(``n_group``, ``topk_group``), no ``routed_scaling_factor`` and no
bias-based balancing (``topk_method``, ``scoring_func``); RoPE without
YaRN scaling (``rope_scaling``), the halves convention. The
configuration's file keeps the published values of those keys and names
each departure under ``assumed``; the keys above are read from the code
here, not from the file. Its ``reduced`` names the cuts: no multi-token
prediction module (``num_nextn_predict_layers``) and fewer layers
(``num_hidden_layers``).
The router's product stays float32 in the fp8 control, as in the program.
"""
from __future__ import annotations

import math

import torch

from reference.common import (causal_attention, exact_matmuls, mm, rd, rms,
                              rope, swiglu)

CAPACITY = 1.25


def _mla(p, i, h, pos, cfg, precision):
    s, d = h.shape
    hh = cfg["num_attention_heads"]
    nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    kvr, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    ql = rms(mm(h, p["wq_a"][i], precision), p["q_norm"][i], eps, precision)
    q = mm(ql, p["wq_b"][i].reshape(ql.shape[-1], -1), precision
           ).view(s, hh, nope + rp)
    q = torch.cat([q[..., :nope], rd(rope(q[..., nope:], pos, theta),
                                      precision)], -1)
    kv = mm(h, p["wkv_a"][i], precision)
    ckv = rms(kv[:, :kvr], p["kv_norm"][i], eps, precision)
    k_rope = rd(rope(kv[:, None, kvr:], pos, theta), precision)
    k_nope = mm(ckv, p["wk_b"][i].reshape(kvr, -1), precision
                ).view(s, hh, nope)
    v = mm(ckv, p["wv_b"][i].reshape(kvr, -1), precision).view(s, hh, dv)
    k = torch.cat([k_nope, k_rope.expand(s, hh, rp)], -1)
    del k_nope, ckv, kv, ql
    o = causal_attention(q, k, v, 1.0 / math.sqrt(nope + rp), block=256)
    return mm(rd(o.reshape(s, -1), precision), p["wo"][i].reshape(-1, d),
              precision)


def _kept(idx, n_prompt: int, n_experts: int):
    """Which (row, choice) pairs the experts take: the prompt's rows
    capacity-bounded as one dispatch, the rest all."""
    keep = torch.ones_like(idx, dtype=torch.bool)
    k = idx.shape[1]
    cap = max(1, int(CAPACITY * n_prompt * k / n_experts))
    flat = idx[:n_prompt].reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(se.numel(), device=idx.device) - first
    kp = torch.empty_like(flat, dtype=torch.bool)
    kp[order] = rank < cap
    keep[:n_prompt] = kp.view(n_prompt, k)
    return keep


def _moe(p, i, h, n_prompt, cfg, precision):
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ p["router"][i].float(), -1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    keep = _kept(idx, n_prompt, e)
    y = torch.zeros_like(h)
    for ex in range(e):
        rows, cols = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        ye = swiglu(h[rows], p["wi_gate"][i, ex], p["wi_up"][i, ex],
                    p["wo"][i, ex], precision)
        y.index_add_(0, rows, ye * gates[rows, cols][:, None])
    y = rd(y, precision)
    for j in range(cfg["n_shared_experts"]):
        sh = p[f"shared_{j}"]
        y = rd(y + swiglu(h, sh["wi_gate"][i], sh["wi_up"][i], sh["wo"][i],
                          precision), precision)
    return y


def served_logits(cfg, params, prompt, visual, served,
                  precision: str = "f32") -> torch.Tensor:
    """[len(served), vocab] float32 logits that predicted each served
    token, for one text request (``visual`` must be None)."""
    if visual is not None:
        raise ValueError("deepseek-v3 takes no image")
    eps = cfg["rms_norm_eps"]
    tok = params["embed"]["tok"]
    dev = tok.device
    kd = cfg["first_k_dense_replace"]
    with exact_matmuls():
        ids = torch.as_tensor(list(prompt) + list(served[:-1]),
                              dtype=torch.long, device=dev)
        x = tok[ids].float()
        pos = torch.arange(x.shape[0], device=dev)
        segs = [("dense_layers", kd),
                ("layers", cfg["num_hidden_layers"] - kd)]
        for key, n in segs:
            lay = params.get(key)
            for i in range(n):
                h = rms(x, lay["ln1"]["scale"][i], eps, precision)
                x = rd(x + _mla(lay["attn"], i, h, pos, cfg, precision),
                       precision)
                h = rms(x, lay["ln2"]["scale"][i], eps, precision)
                if "moe" in lay:
                    f = _moe(lay["moe"], i, h, len(prompt), cfg, precision)
                else:
                    m = lay["mlp"]
                    f = swiglu(h, m["wi_gate"][i], m["wi_up"][i],
                               m["wo"][i], precision)
                x = rd(x + f, precision)
        first = len(prompt) - 1
        rows = rms(x[first:first + len(served)],
                   params["final_norm"]["scale"], eps, precision)
        return mm(rows, params["embed"]["unembed"], precision)
