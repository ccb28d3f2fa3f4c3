"""Visual token pruning (survey dim 1a).

Port of ``repro.core.token_compression.pruning``. All pruners share one
signature:

    prune(embeds, keep, *, scores=None, query=None, key=None)
        embeds : [B, N, d]  visual token embeddings
        keep   : int        number of tokens to retain
        -> (kept_embeds [B, keep, d], kept_idx [B, keep] int64, info dict)

``kept_idx`` is always sorted ascending so downstream positional encodings
stay monotone (the survey's §V RoPE-decay caveat). It is int64, PyTorch's
index type (the reference returns int32; the values are the same).

Every function runs on the device of its inputs and never reads a tensor
back to the host, so a CUDA request compresses on the card. The greedy
pruners (divprune, cdpruner) are a Python loop of a few launches per kept
token, where the reference runs ``lax.scan``.

Implemented (each cites its surveyed source):
  * fastv        -- attention-score pruning after layer k [FastV]
  * sparsevlm    -- query-conditioned cross-modal relevance [SparseVLM/TRIM]
  * l2           -- low L2-norm keys ~ high attention proxy [L2Compress];
                    attention-free, applicable to SSM backbones (DESIGN §3)
  * divprune     -- Max-Min Diversity Problem greedy 2-approximation [DivPrune]
  * cdpruner     -- conditional-diversity DPP greedy MAP [CDPruner]
  * pyramiddrop  -- progressive multi-stage schedule helper [PyramidDrop]
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Out = Tuple[torch.Tensor, torch.Tensor, Dict]


def unit(x: torch.Tensor) -> torch.Tensor:
    """``x / (||x|| + 1e-6)`` along the last axis, in x's own dtype."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def promoted(a: torch.Tensor, b: torch.Tensor):
    """``a``, ``b`` cast to their common dtype. ``jnp.einsum`` promotes a
    bf16 x float32 product to float32; ``torch.einsum`` raises on mixed
    dtypes (a bf16 prompt query against float32 visual embeddings at full
    width), so the operands are promoted explicitly, after each was
    normalised in its own dtype as the reference does."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``scores`` along the last axis, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values. ``torch.topk`` makes no promise on ties (on
    ``[1,3,3,0,3,3,1,3]`` with k=5 it may return ``[1,4,5,7,2]`` where JAX
    returns ``[1,2,4,5,7]``), so a cut through a run of ties would keep
    other tokens. A stable descending sort keeps ties in index order."""
    return torch.sort(scores, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def take(embeds: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [B, K] of ``embeds`` [B, N, d] -> [B, K, d]."""
    return torch.gather(embeds, 1,
                        idx[..., None].expand(-1, -1, embeds.shape[-1]))


def _topk_sorted(scores, keep) -> torch.Tensor:
    """Top-``keep`` indices, returned in ascending positional order."""
    return torch.sort(topk_indices(scores, keep), dim=-1).values


# --------------------------------------------------------------------------

def prune_fastv(embeds, keep, *, scores, **_) -> Out:
    """FastV: keep visual tokens with highest received attention.

    ``scores`` [B, N]: mean attention each visual token receives from all
    queries at the pruning layer (layer 2 in the paper). Task-agnostic --
    its failure mode on fine-grained prompts is what SparseVLM fixes.
    """
    idx = _topk_sorted(scores, keep)
    return take(embeds, idx), idx, {"criterion": "attn"}


def prune_sparsevlm(embeds, keep, *, query, **_) -> Out:
    """SparseVLM/TRIM: rank by relevance to the user query.

    ``query`` [B, Q, d] text-token embeddings; relevance = max cosine
    similarity of each visual token to any query token.
    """
    v, q = promoted(unit(embeds), unit(query))
    rel = torch.einsum("bnd,bqd->bnq", v, q).amax(-1)       # [B,N]
    idx = _topk_sorted(rel, keep)
    return take(embeds, idx), idx, {"criterion": "query-relevance"}


def prune_l2(embeds, keep, *, key=None, **_) -> Out:
    """L2Compress: low key-norm correlates with high attention.

    ``key`` [B, N, d_k] are the attention KEY embeddings of the visual
    tokens when a caller has them (the engine does not pass any); without
    them the token embeddings stand in -- an attention-FREE salience proxy
    (survey §V open problem), hence the pruner of record for SSM backbones.
    """
    target = key if key is not None else embeds
    norms = torch.linalg.vector_norm(target.float(), dim=-1)
    idx = _topk_sorted(-norms, keep)                        # low norm = keep
    return take(embeds, idx), idx, {"criterion": "l2"}


def prune_divprune(embeds, keep, **_) -> Out:
    """DivPrune: greedy Max-Min-Diversity (2-approx of MMDP).

    Iteratively adds the token whose minimum distance to the selected set
    is largest; drops duplicate textures (sky/wall) regardless of salience.
    Seeded with token 0, ``keep - 1`` greedy steps (the reference's scan).
    """
    b, n, _ = embeds.shape
    x = unit(embeds.float())
    dist = 1.0 - torch.einsum("bnd,bmd->bnm", x, x)         # [B,N,N]
    bidx = torch.arange(b, device=embeds.device)
    min_dist = dist[:, 0].clone()
    selected = torch.zeros((b, n), dtype=torch.bool, device=embeds.device)
    selected[:, 0] = True
    picks = [torch.zeros(b, dtype=torch.long, device=embeds.device)]
    # one step = a few launches; nothing here reads a tensor on the host,
    # so the loop only enqueues (argmax takes the first maximum, as JAX)
    for _ in range(keep - 1):
        nxt = min_dist.masked_fill(selected, -math.inf).argmax(-1)   # [B]
        selected[bidx, nxt] = True
        min_dist = torch.minimum(min_dist, dist[bidx, nxt])
        picks.append(nxt)
    idx = torch.sort(torch.stack(picks, 1), dim=-1).values
    return take(embeds, idx), idx, {"criterion": "max-min-diversity"}


def prune_cdpruner(embeds, keep, *, query=None, **_) -> Out:
    """CDPruner: greedy MAP of a (conditional) DPP.

    Kernel L = diag(q) * S * diag(q): S = cosine similarity, q = relevance
    to the instruction (uniform when no query). Greedy MAP via Cholesky-
    style update selects a set that is jointly diverse AND relevant.
    """
    b, n, _ = embeds.shape
    dev = embeds.device
    xn = unit(embeds.float())
    s = torch.einsum("bnd,bmd->bnm", xn, xn)
    if query is not None:
        xq, qn = promoted(xn, unit(query))
        rel = (torch.einsum("bnd,bqd->bnq", xq, qn).amax(-1) + 1.0) / 2.0
    else:
        rel = torch.ones((b, n), dtype=torch.float32, device=dev)
    l_kern = rel[:, :, None] * s * rel[:, None, :]

    # greedy DPP MAP (incremental marginal-gain, O(keep * N) per batch);
    # a Python loop of a few launches per step, no host reads
    bidx = torch.arange(b, device=dev)
    di2 = torch.diagonal(l_kern, dim1=1, dim2=2).clone()    # [B,N]
    cis = torch.zeros((b, keep, n), dtype=torch.float32, device=dev)
    selected = torch.zeros((b, n), dtype=torch.bool, device=dev)
    picks = []
    for step in range(keep):
        gain = torch.log(di2 + 1e-12).masked_fill(selected, -math.inf)
        j = gain.argmax(-1)                                  # [B]
        dj = torch.sqrt(di2[bidx, j] + 1e-12)                # [B]
        # e_i = (L[j,i] - <c_j, c_i>) / d_j
        cjj = cis[bidx, :, j]                                # [B,K]
        e = (l_kern[bidx, j] - torch.einsum("bkn,bk->bn", cis, cjj)
             ) / dj[:, None]
        cis[:, step] = e
        di2 = torch.clamp_min(di2 - e * e, 0.0)
        selected[bidx, j] = True
        picks.append(j)
    idx = torch.sort(torch.stack(picks, 1), dim=-1).values
    return take(embeds, idx), idx, {"criterion": "conditional-dpp"}


# --------------------------------------------------------------------------

def pyramiddrop_schedule(n_tokens: int, num_layers: int, stages: int = 4,
                         final_keep_ratio: float = 0.125):
    """PyramidDrop: per-stage (layer, keep) schedule.

    Returns [(layer_idx, n_keep), ...] dropping progressively: rather than
    FastV's single aggressive drop, tokens shrink geometrically across
    ``stages`` evenly spaced depths.
    """
    out = []
    ratio = final_keep_ratio ** (1.0 / stages)
    keep = n_tokens
    for s in range(stages):
        layer = max(1, (s + 1) * num_layers // (stages + 1))
        keep = max(1, int(math.ceil(keep * ratio)))
        out.append((layer, keep))
    return out


PRUNERS = {
    "fastv": prune_fastv,
    "sparsevlm": prune_sparsevlm,
    "l2": prune_l2,
    "divprune": prune_divprune,
    "cdpruner": prune_cdpruner,
}
