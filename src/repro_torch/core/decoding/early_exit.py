"""Early exit / layer skipping (survey dim 4b): AdaInfer-style adaptive depth.

Port of ``repro.core.decoding.early_exit``: the training-free confidence
variant. After layer l, p_l = softmax(unembed(norm(h_l))); exit once
max p_l > threshold and the argmax has held for ``patience`` layers.

The decode step is a host-side loop over the stacked layers (each layer's
params and cache are views), so the exit is a real ``break``: the layers
after it never run. Each logit-lens check reads its confidence and argmax
on the host (one sync per layer): that is the algorithm. The skipped
layers' KV is back-filled with the exit hidden state through
``decode_attention`` (the paged kernel on the card; ``mla_decode_attention``
and the latent kernel on an MLA model), so later tokens see a consistent
cache. The caller's cache is updated in place: every layer's
cache is a view of it (asserted), so a batch-1 view of an engine's slot
pool receives the writes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import _dense_layer_decode, _layer


def _layer_cache(cache, i: int):
    """Layer ``i``'s cache, asserted to be a view of ``cache`` (writes
    through it must land in the caller's tensors)."""
    lc = _layer(cache["layers"], i)
    for name, leaf in lc.items():
        whole = cache["layers"][name]
        assert leaf.untyped_storage().data_ptr() == \
            whole.untyped_storage().data_ptr(), \
            f"layer {i} cache {name!r} is a copy, not a view"
    return lc


def _positions(model, x, pos):
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().reshape(-1).expand(b)
    return pos, model._cos_sin(pos[:, None])


def _lens(params, x, cfg):
    """Logit-lens logits [B, V] of a hidden state [B, 1, d]."""
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.unembed(params["embed"], h, cfg.logits_softcap)[:, 0]


def layer_confidences(model, params, cache, tokens, pos) -> torch.Tensor:
    """Diagnostic: run the ``layers`` stack, return [n, B] logit-lens
    max-prob (n = num_layers, less a MoE model's dense prefix, which the
    reference does not run here either)."""
    cfg = model.cfg
    x = L.embed_tokens(params["embed"], tokens)
    pos, (cos, sin) = _positions(model, x, pos)
    confs = []
    n = cfg.num_layers - cfg.first_k_dense_layers \
        if cfg.family == "moe" else cfg.num_layers
    for i in range(n):
        x, _ = _dense_layer_decode(cfg, _layer(params["layers"], i), x, cos,
                                   sin, _layer_cache(cache, i), pos,
                                   window=0)
        confs.append(torch.softmax(_lens(params, x, cfg),
                                   -1).amax(-1))
    return torch.stack(confs)            # [L, B]


def early_exit_decode_step(model, params, cache, tokens, pos, *,
                           threshold: float = 0.9, patience: int = 2,
                           min_layers: int = 2
                           ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One decode step with confidence-based early exit.

    Returns (logits [B,V], cache, info) where info['layers_used'] is the
    depth executed and info['exited'] whether the threshold fired. The
    batch exits jointly (min confidence across the batch).
    """
    cfg = model.cfg
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError("early exit targets attention families")
    if cfg.family == "moe" and cfg.first_k_dense_layers:
        raise NotImplementedError("early exit w/ dense-prefix MoE unsupported")
    x = L.embed_tokens(params["embed"], tokens)
    pos, (cos, sin) = _positions(model, x, pos)
    n = cfg.num_layers
    last_argmax = None
    stable = 0
    exited = False
    logits = None
    used = n
    for i in range(n):
        x, _ = _dense_layer_decode(cfg, _layer(params["layers"], i), x, cos,
                                   sin, _layer_cache(cache, i), pos,
                                   window=0)
        if i + 1 < min_layers:
            continue
        logits = _lens(params, x, cfg)
        conf = float(torch.softmax(logits, -1).amax(-1).min())
        am = torch.argmax(logits, -1)
        if last_argmax is not None and bool((am == last_argmax).all()):
            stable += 1
        else:
            stable = 0
        last_argmax = am
        if conf > threshold and stable >= patience:
            used = i + 1
            exited = True
            break
    if logits is None:                  # min_layers > n edge case
        logits = _lens(params, x, cfg)

    if exited:
        # identity skip: back-fill skipped layers' KV with the exit hidden
        # state so FUTURE tokens see a consistent cache
        decode = attn.mla_decode_attention if cfg.use_mla \
            else attn.decode_attention
        for i in range(used, n):
            lp = _layer(params["layers"], i)
            h = L.apply_norm(lp["ln1"], x, cfg.norm)
            decode(lp["attn"], h, cos, sin, cfg, _layer_cache(cache, i), pos)

    info = {"layers_used": used, "exited": exited, "flops_frac": used / n}
    return logits, cache, info
