"""KV cache budget allocation across layers (survey dim 2a-ii).

Port of ``repro.core.kv_cache.budget``: the three allocators are the
reference's numpy code, copied; ``cake_layer_scores`` reads torch tensors
(or arrays) where the reference reads jax arrays.

Given a total token budget for the whole model, distribute per-layer:

  * uniform    -- equal share (the baseline the papers beat)
  * pyramid    -- PyramidKV: arithmetic decay, shallow layers get more
  * adaptive   -- DynamicKV/CAKE flavor: proportional to measured per-layer
                  attention dispersion/recency statistics
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def uniform_budgets(total: int, num_layers: int,
                    min_per_layer: int = 8) -> List[int]:
    base = max(min_per_layer, total // num_layers)
    return [base] * num_layers


def pyramid_budgets(total: int, num_layers: int, *, beta: float = 20.0,
                    min_per_layer: int = 8) -> List[int]:
    """PyramidKV: linearly decaying budgets, sum == total.

    The first layer gets ~2x the mean, the last ~beta-th of the first;
    an arithmetic sequence normalized to the total (paper's funnel shape).
    """
    # a total below min_per_layer*layers cannot respect the floor: shrink it
    min_per_layer = min(min_per_layer, max(1, total // num_layers))
    first = 2.0 * total / num_layers
    last = max(first / beta, float(min_per_layer))
    raw = np.linspace(first, last, num_layers)
    raw = raw / raw.sum() * total
    out = np.maximum(min_per_layer, np.round(raw)).astype(int)
    # fix rounding drift on the largest entries (bounded sweep)
    drift = int(out.sum()) - total
    i = 0
    while drift != 0 and i < 10 * num_layers:
        j = i % num_layers
        step = -1 if drift > 0 else 1
        if out[j] + step >= min_per_layer:
            out[j] += step
            drift += step
        i += 1
    return out.tolist()


def adaptive_budgets(total: int, layer_scores: Sequence[float], *,
                     min_per_layer: int = 8, temperature: float = 1.0
                     ) -> List[int]:
    """DynamicKV/CAKE: budgets proportional to per-layer importance scores.

    ``layer_scores`` come from measured attention statistics -- e.g. the
    entropy (spatial dispersion) plus variance-over-steps (temporal shift)
    of each layer's attention, CAKE's two "preference" terms.
    """
    min_per_layer = min(min_per_layer,
                        max(1, total // max(1, len(layer_scores))))
    s = np.asarray(layer_scores, np.float64)
    s = np.maximum(s, 1e-9) ** (1.0 / max(temperature, 1e-6))
    raw = s / s.sum() * total
    out = np.maximum(min_per_layer, np.round(raw)).astype(int)
    drift = int(out.sum()) - total
    order = np.argsort(-out)
    i = 0
    while drift != 0 and i < 10 * len(out):
        j = order[i % len(out)]
        step = -1 if drift > 0 else 1
        if out[j] + step >= min_per_layer:
            out[j] += step
            drift += step
        i += 1
    return out.tolist()


def cake_layer_scores(attn_list) -> List[float]:
    """CAKE preference scores from per-layer attention [B,H,Sq,S] arrays.

    score = spatial dispersion (entropy over keys) * temporal dynamism
    (variance of per-key attention across query steps).
    """
    out = []
    for a in attn_list:
        p = torch.as_tensor(a).float().mean(dim=(0, 1))          # [Sq,S]
        p = p / (p.sum(-1, keepdim=True) + 1e-9)
        ent = -(p * torch.log(p + 1e-9)).sum(-1).mean()
        var = p.var(dim=0, correction=0).sum()
        out.append(float(ent * (1.0 + var)))
    return out
