"""Sparse Mixture-of-Experts: top-k router, capacity-bounded dispatch.

Port of ``repro.models.moe`` (the Arctic / DeepSeek-style layer):

  * a top-k softmax router over float32 logits, gates renormalised;
  * sort-based dispatch: the (token, choice) pairs are sorted stably by
    expert id and scattered into an ``[E, C + 1, d]`` buffer, column C
    taking every pair past the capacity (dropped, sliced off), then one
    batched matmul per expert weight and a float32 ``index_add_`` combine;
  * optional shared experts and Arctic's parallel dense residual MLP;
  * the router's load-balance and z losses in an aux dict.

One token group. The reference splits the tokens into one group per data
shard of its mesh (``_mesh_groups``) and is one group without a mesh; the
port runs on one device with no mesh, so it is always one group, and the
capacity is that of the whole batch. The expert products are plain
batched matmuls (``torch.matmul`` over the expert axis), as the reference
leaves its einsums to XLA: no kernel of the port is involved.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, apply_mlp, mlp_specs, spec


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    out = {"router": spec((d, e), ("embed", None), scale=0.02)}
    if cfg.activation == "swiglu":
        out["wi_gate"] = spec((e, d, f), ("expert", "embed", "moe_ffn"))
        out["wi_up"] = spec((e, d, f), ("expert", "embed", "moe_ffn"))
        out["wo"] = spec((e, f, d), ("expert", "moe_ffn", "embed"))
    else:
        out["wi"] = spec((e, d, f), ("expert", "embed", "moe_ffn"))
        out["wo"] = spec((e, f, d), ("expert", "moe_ffn", "embed"))
    for i in range(cfg.num_shared_experts):
        out[f"shared_{i}"] = mlp_specs(cfg, d_ff=cfg.moe_d_ff)
    if cfg.dense_residual:
        out["dense"] = mlp_specs(cfg)
    return out


def _expert_ffn(p, buf, activation: str):
    """buf [E, C, d] -> [E, C, d]: each expert's FFN on its rows (batched
    matmuls over the expert axis, float32 activation, back to buf's
    dtype)."""
    if activation == "swiglu":
        h = F.silu(torch.matmul(buf, p["wi_gate"]).float()) \
            * torch.matmul(buf, p["wi_up"]).float()
    else:
        h = torch.matmul(buf, p["wi"]).float()
        h = torch.relu(h).square() if activation == "relu2" \
            else F.gelu(h, approximate="tanh")
    return torch.matmul(h.to(buf.dtype), p["wo"]).to(buf.dtype)


def apply_moe(p, x, cfg, *, capacity_factor: Optional[float] = 1.25
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,d] -> (y [B,S,d], aux with ``lb_loss``, ``z_loss``, ``load``
    [E] and ``dropped_frac``).

    ``capacity_factor=None`` is dropless (C = T * k, the serving
    setting); otherwise C = max(1, int(factor * T * k / E)) and the
    pairs past an expert's C (in token order) are dropped.
    """
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(t, d)

    logits = torch.matmul(xf.float(), p["router"].float())     # [T, E]
    probs = torch.softmax(logits, -1)
    gates, idx = torch.topk(probs, k, dim=-1)                   # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # ---- capacity-bounded sort-based dispatch ----------------------------
    cap = t * k if capacity_factor is None \
        else max(1, int(capacity_factor * t * k / e))
    flat_e = idx.reshape(-1)
    tok_id = torch.arange(t * k, device=x.device) // k
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], tok_id[order]
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = torch.arange(t * k, device=x.device) - first
    keep = pos_in_e < cap
    dest_c = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[se, dest_c] = xf[st]                   # column cap: the drops
    flat_g = gates.reshape(-1)[order] * keep

    y_buf = _expert_ffn(p, buf[:, :cap], cfg.activation)        # [E, C, d]
    y_pad = F.pad(y_buf, (0, 0, 0, 1))                          # drop col
    vals = y_pad[se, dest_c] * flat_g[:, None].to(x.dtype)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device
                      ).index_add_(0, st, vals.float()).to(x.dtype)

    # ---- shared experts / dense residual -----------------------------------
    for i in range(cfg.num_shared_experts):
        out = out + apply_mlp(p[f"shared_{i}"], xf, cfg.activation)
    if cfg.dense_residual:
        out = out + apply_mlp(p["dense"], xf, cfg.activation)

    # ---- router aux losses (Switch/GShard load balance + z-loss) ---------
    load = torch.bincount(idx.reshape(-1), minlength=e).float() / (t * k)
    importance = probs.mean(0)
    aux = {"lb_loss": e * torch.sum(load * importance),
           "z_loss": torch.logsumexp(logits, -1).square().mean(),
           "load": load,
           "dropped_frac": 1.0 - keep.float().mean()}
    return out.reshape(b, s, d), aux
