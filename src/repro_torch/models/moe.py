"""Sparse Mixture-of-Experts: top-k router, capacity-bounded dispatch.

Port of ``repro.models.moe`` (the Arctic / DeepSeek-style layer):

  * a top-k softmax router over float32 logits, gates renormalised;
  * sort-based dispatch: the (token, choice) pairs are sorted stably by
    expert id and scattered into an ``[E, C + 1, d]`` buffer, column C
    taking every pair past the capacity (dropped, sliced off), then one
    batched matmul per expert weight and a float32 ``index_add_`` combine;
  * optional shared experts and Arctic's parallel dense residual MLP;
  * the router's load-balance and z losses in an aux dict.

Dispatch is grouped, as the reference's: the tokens split into one group
per data shard of the current mesh (``_mesh_groups``, the product of its
"pod" and "data" sizes, ``sharding.use_mesh``), each group sort-dispatches
into its own capacity buffer (together [E, G, C_g, d], the experts
first, so the expert products need no transpose) with C_g from the group's
tokens. Without a mesh (every serving and training path of the port) it
is one group, and the capacity is that of the whole batch. Under a mesh
the sort dispatch and the combine run on each rank's local groups
(``sharding.context.local``), and the buffers are constrained experts
-> "model", groups -> batch axes (``_constrain``). The expert products are
plain batched matmuls (``torch.matmul`` over the expert axis), as the
reference leaves its einsums to XLA: no kernel of the port is involved.

``apply_moe(profiler=)`` times the layer as the ``model.moe`` site, a lap
of the profiler (``Profiler.laps``, filed by the model after its layer
loop), with ``pairs`` (the (token, choice) pairs dispatched) and
``buffer_rows`` (the dispatch buffers' rows, E * (C + 1) a group), host
ints of the shapes it used: their ratio is how full the expert buffers
ran.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, apply_mlp, mlp_specs, spec
from repro_torch.obs.profile import NULL_PROFILER
from repro_torch.sharding.context import (Arg, batch_groups, constrain,
                                          local, matmul)


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
    """buf [E, G, C, d] -> [E, G, C, d]: each expert's FFN on its rows
    (one batched matmul over the expert axis, the groups' rows flattened;
    float32 activation, back to buf's dtype)."""
    def mm(x, w):
        e, g, c, d = x.shape
        return matmul(x.reshape(e, g * c, d), w).reshape(e, g, c, -1)
    if activation == "swiglu":
        h = F.silu(mm(buf, p["wi_gate"]).float()) \
            * mm(buf, p["wi_up"]).float()
    else:
        h = mm(buf, p["wi"]).float()
        h = torch.relu(h).square() if activation == "relu2" \
            else F.gelu(h, approximate="tanh")
    return mm(h.to(buf.dtype), p["wo"]).to(buf.dtype)


def _mesh_groups(t: int) -> Tuple[int, Optional[Tuple[str, ...]], int]:
    """Token groups for sharded dispatch = the mesh's batch extent.

    A global argsort over all tokens cannot be partitioned: every dispatch
    op would need the whole token stream. Sorting within per-data-shard
    groups keeps every dispatch op local to its shard (GShard's grouping).
    (1, None, 1) without a mesh, or when the tokens do not divide."""
    g, axes, model = batch_groups()
    if g > 1 and t % g == 0:
        return g, axes, model
    return 1, None, 1


_constrain = constrain          # the reference's name for the hook


def _dispatch(xg, idx, gates, cap: int, e: int):
    """Each group's sort dispatch: xg [G,Tg,d], idx / gates [G,Tg,k] ->
    (buf [E,G,C,d], se, dest_c, st, flat_g, keep [G,Tg*k]). The (token,
    choice) pairs are sorted stably by expert id and scattered into an
    [E, C + 1, d] buffer, column C taking every pair past the capacity
    (dropped, sliced off)."""
    bufs, metas = [], []
    for xf, idx_g, gates_g in zip(xg, idx, gates):
        n = idx_g.numel()
        k = idx_g.shape[-1]
        flat_e = idx_g.reshape(-1)
        tok_id = torch.arange(n, device=xf.device) // k
        order = torch.argsort(flat_e, stable=True)
        se, st = flat_e[order], tok_id[order]
        first = torch.searchsorted(se, se, side="left")
        pos_in_e = torch.arange(n, device=xf.device) - first
        keep = pos_in_e < cap
        dest_c = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))
        buf = torch.zeros((e, cap + 1, xf.shape[-1]), dtype=xf.dtype,
                          device=xf.device)
        buf[se, dest_c] = xf[st]                   # column cap: the drops
        bufs.append(buf[:, :cap])
        metas.append((se, dest_c, st, gates_g.reshape(-1)[order] * keep,
                      keep))
    return (torch.stack(bufs, 1),) + tuple(torch.stack(m)
                                           for m in zip(*metas))


def _combine(y_buf, se, dest_c, st, flat_g, tg: int):
    """Each group's weighted gather back to token order: y_buf [E,G,C,d]
    and the dispatch's pairs -> [G,Tg,d] (float32 ``index_add_``)."""
    outs = []
    for y_g, se_g, dc_g, st_g, fg in zip(y_buf.unbind(1), se, dest_c, st,
                                         flat_g):
        y_pad = F.pad(y_g, (0, 0, 0, 1))                        # drop col
        vals = y_pad[se_g, dc_g] * fg[:, None].to(y_g.dtype)
        outs.append(torch.zeros((tg, y_g.shape[-1]), dtype=torch.float32,
                                device=y_g.device
                                ).index_add_(0, st_g, vals.float()
                                             ).to(y_g.dtype))
    return torch.stack(outs)


def apply_moe(p, x, cfg, *, capacity_factor: Optional[float] = 1.25,
              profiler=NULL_PROFILER
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,d] -> (y [B,S,d], aux with ``lb_loss``, ``z_loss``, ``load``
    [E] and ``dropped_frac``).

    ``capacity_factor=None`` is dropless (C = Tg * k, the serving
    setting); otherwise C = max(1, int(factor * Tg * k / E)) over a
    group's Tg tokens (all T without a mesh), and the pairs past an
    expert's C (in token order) are dropped. ``profiler``: the
    ``model.moe`` site (see the module docstring).
    """
    if profiler.enabled:
        t_begin = profiler.clock()
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.num_experts
    g, batch_axes, _ = _mesh_groups(t)
    if (t // g) * k < e:
        # decode-scale token counts: per-group capacity would starve the
        # expert axis (slots per group < experts); dispatch globally
        g, batch_axes = 1, None
    tg = t // g
    xg = x.reshape(g, tg, d)
    xf = x.reshape(t, d)
    if batch_axes:
        xg = _constrain(xg, (batch_axes, None, None))
        # the token rows stay on the batch axes only: a gradient that comes
        # back sharded over "model" too would not fit a reshape's view
        xf = _constrain(xf, (batch_axes, None))

    logits = matmul(xg.float(), p["router"].float())     # [G, Tg, E]
    probs = torch.softmax(logits, -1)
    gates, idx = torch.topk(probs, k, dim=-1)                   # [G, Tg, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # ---- per-group capacity-bounded sort-based dispatch -------------------
    cap = tg * k if capacity_factor is None \
        else max(1, int(capacity_factor * tg * k / e))
    bufs, se, dest_c, st, flat_g, keep = local(
        lambda xg, idx, gates: _dispatch(xg, idx, gates, cap, e),
        [Arg(xg, 0), Arg(idx, 0), Arg(gates, 0)],
        [(1, None)] + [(0, None)] * 5)
    # experts model-sharded, groups data-sharded
    if batch_axes:
        bufs = _constrain(bufs, ("model", batch_axes, None, None))
    y_buf = _expert_ffn(p, bufs, cfg.activation)               # [E,G,C,d]
    if batch_axes:
        y_buf = _constrain(y_buf, ("model", batch_axes, None, None))
    out = local(lambda *a: _combine(*a, tg=tg),
                [Arg(y_buf, 1), Arg(se, 0), Arg(dest_c, 0), Arg(st, 0),
                 Arg(flat_g, 0)], [(0, None)]).reshape(t, d)
    if batch_axes:
        out = _constrain(out, (batch_axes, None))

    # ---- shared experts / dense residual -----------------------------------
    for i in range(cfg.num_shared_experts):
        out = out + apply_mlp(p[f"shared_{i}"], xf, cfg.activation)
    if cfg.dense_residual:
        out = out + apply_mlp(p["dense"], xf, cfg.activation)

    # ---- router aux losses (Switch/GShard load balance + z-loss) ---------
    experts = torch.arange(e, device=x.device)
    load = (idx[..., None] == experts).float().sum((0, 1, 2)) / (t * k)
    importance = probs.mean((0, 1))
    aux = {"lb_loss": e * torch.sum(load * importance),
           "z_loss": torch.logsumexp(logits, -1).square().mean(),
           "load": load,
           "dropped_frac": 1.0 - keep.float().mean()}
    if profiler.enabled:
        profiler.laps.append(("model.moe", t_begin, profiler.clock(),
                              {"pairs": g * tg * k,
                               "buffer_rows": g * e * (cap + 1)}))
    return out.reshape(b, s, d), aux
