"""KV cache selection (survey dim 2a-i): static + dynamic token retention.

Port of ``repro.core.kv_cache.selection``. Uniform signature over a single
layer's cache:

    select(k, v, *, budget, attn=None, pos=None)
        k, v  : [B, S, H, D]
        attn  : [B, Hq, Sq, S] attention probs (observation window or
                accumulated), required by attention-based selectors
        pos   : [S] absolute positions (default arange, int32)
        -> (k' [B,budget,H,D], v' [B,budget,H,D], kept_pos [B,budget])

  * snapkv     -- observation-window voting, static one-shot post-prefill
  * h2o        -- heavy hitters (accumulated attention) + recent window
  * streaming  -- attention sinks + recent window (position-only)
  * l2         -- low key-L2-norm retention (attention-free)

Every cut goes through ``pruning.topk_indices`` (``jax.lax.top_k``'s order:
the lower index first among ties), so streaming's ``inf`` sinks and any
other tied scores keep the reference's tokens. Kept positions are int32,
as the reference's. Plain PyTorch on the inputs' device: the engine
selects a whole slot at once by passing the layers as the batch axis.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.token_compression.pruning import topk_indices

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _gather(k, v, idx):
    """idx [B, budget] -> gathered caches."""
    ix = idx[:, :, None, None].expand(-1, -1, k.shape[2], k.shape[3])
    return torch.gather(k, 1, ix), torch.gather(v, 1, ix)


def _finish(k, v, scores, budget, pos) -> Out:
    idx = torch.sort(topk_indices(scores, budget), dim=-1).values
    k2, v2 = _gather(k, v, idx)
    kept_pos = torch.gather(pos[None].expand(scores.shape), 1, idx)
    return k2, v2, kept_pos.to(torch.int32)


def _default_pos(s, device):
    return torch.arange(s, dtype=torch.int32, device=device)


def select_snapkv(k, v, *, budget, attn, pos=None, obs_window: int = 16,
                  kernel: int = 5) -> Out:
    """SnapKV: votes from the last ``obs_window`` queries, pooled.

    attn [B,Hq,Sq,S]: full-prompt attention; only the final observation
    window's rows vote. 1D pooling smooths the votes so adjacent context
    survives together (as in the paper). The observation window itself is
    always retained (forced +inf score).
    """
    s = k.shape[1]
    pos = _default_pos(s, k.device) if pos is None else pos
    votes = attn[:, :, -obs_window:, :].sum(dim=(1, 2))        # [B,S]
    # avg-pool1d smoothing with edge padding
    pad = kernel // 2
    vp = F.pad(votes[:, None], (pad, pad), mode="replicate")[:, 0]
    votes = torch.stack([vp[:, i:i + s] for i in range(kernel)], 0).mean(0)
    votes[:, -obs_window:] = torch.inf
    return _finish(k, v, votes, budget, pos)


def select_h2o(k, v, *, budget, attn, pos=None, recent_frac: float = 0.5
               ) -> Out:
    """H2O: heavy hitters by accumulated attention + recent window.

    Half the budget (recent_frac) is the most recent tokens; the rest are
    the highest accumulated-attention "heavy hitters".
    """
    s = k.shape[1]
    pos = _default_pos(s, k.device) if pos is None else pos
    scores = attn.sum(dim=(1, 2))                              # [B,S]
    n_recent = max(1, int(budget * recent_frac))
    scores[:, -n_recent:] = torch.inf
    return _finish(k, v, scores, budget, pos)


def select_streaming(k, v, *, budget, attn=None, pos=None, sinks: int = 4
                     ) -> Out:
    """StreamingLLM: attention sinks (first ``sinks`` tokens) + recent.

    Purely positional -- no attention needed; the sink retention encodes
    the paper's "attention sink" stability phenomenon.
    """
    b, s = k.shape[0], k.shape[1]
    pos = _default_pos(s, k.device) if pos is None else pos
    scores = torch.arange(s, dtype=torch.float32,
                          device=k.device)[None].repeat(b, 1)  # recency
    scores[:, :sinks] = torch.inf                              # sinks forced
    return _finish(k, v, scores, budget, pos)


def select_l2(k, v, *, budget, attn=None, pos=None) -> Out:
    """L2Compress: low key-norm ~ high attention (static, attention-free)."""
    s = k.shape[1]
    pos = _default_pos(s, k.device) if pos is None else pos
    norms = torch.linalg.vector_norm(k.float(), dim=-1).mean(-1)   # [B,S]
    return _finish(k, v, -norms, budget, pos)


SELECTORS = {
    "snapkv": select_snapkv,
    "h2o": select_h2o,
    "streaming": select_streaming,
    "l2": select_l2,
}


def oracle_topk(attn_future, budget) -> torch.Tensor:
    """Oracle: positions that actually receive the most future attention.
    Used by benchmarks to score selector recall. attn_future [B,Hq,Sq,S]
    -> sorted int32 positions [B, budget]."""
    sc = attn_future.sum(dim=(1, 2))
    return torch.sort(topk_indices(sc, budget), dim=-1).values.to(
        torch.int32)
