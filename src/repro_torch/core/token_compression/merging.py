"""Visual token merging (survey dim 1a-b).

Port of ``repro.core.token_compression.merging``:

  * tome_merge        -- ToMe bipartite soft matching (r tokens per pass)
  * prune_then_merge  -- PuMer/ASAP/VisPruner hybrid: prune uninformative,
                         then consolidate survivors onto their nearest kept
                         neighbour (weighted average).

The reference's scatter-adds (``.at[...].add``) are ``scatter_add_``
here. On CUDA their summation order is not fixed (atomics), so merged
embeddings agree with the CPU within a tolerance, not bit for bit; the
kept indices do not depend on it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.token_compression.pruning import (take, topk_indices,
                                                        unit)


def _rows(idx: torch.Tensor, d: int) -> torch.Tensor:
    """[B, M] row indices -> [B, M, d] scatter/gather index."""
    return idx[..., None].expand(-1, -1, d)


def tome_merge(embeds, r: int, *, sizes=None
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """ToMe bipartite soft matching: merge ``r`` tokens into their best match.

    Tokens are split alternating (A = even, B = odd); each A token proposes
    its most similar B token; the ``r`` highest-similarity edges merge
    (size-weighted average), shrinking N by r. ``sizes`` tracks how many
    original tokens each current token represents (for correct averaging
    across repeated passes).

    Returns (merged [B, N-r, d], new_sizes [B, N-r], info).
    """
    b, n, d = embeds.shape
    na = (n + 1) // 2
    nb = n // 2
    if not 0 < r <= min(na, nb):
        raise ValueError(f"tome_merge: r={r} out of range for n={n}")
    dev = embeds.device
    if sizes is None:
        sizes = torch.ones((b, n), dtype=torch.float32, device=dev)

    x = embeds.float()
    xn = unit(x)
    a, bt = xn[:, 0::2], xn[:, 1::2]
    ae, be = x[:, 0::2], x[:, 1::2]
    sa, sb = sizes[:, 0::2], sizes[:, 1::2]

    sim = torch.einsum("bad,bcd->bac", a, bt)               # [B,na,nb]
    best_sim = sim.amax(-1)                                 # [B,na]
    best_dst = sim.argmax(-1)           # first maximum, as jnp.argmax

    # pick r A-tokens with the highest best-similarity to merge away (a
    # tie at the cut keeps the lower index, as lax.top_k)
    merge_src = topk_indices(best_sim, r)                   # [B,r]
    merge_mask = torch.zeros((b, na), dtype=torch.bool, device=dev)
    merge_mask.scatter_(1, merge_src, True)

    # scatter-add merged A tokens into their B destinations (size-weighted)
    w_src = torch.where(merge_mask, sa, 0.0)                # [B,na]
    add_val = torch.zeros_like(be).scatter_add_(
        1, _rows(best_dst, d), ae * w_src[..., None])
    add_size = torch.zeros_like(sb).scatter_add_(1, best_dst, w_src)
    new_b = (be * sb[..., None] + add_val) / (sb + add_size + 1e-9)[..., None]
    new_sb = sb + add_size

    # keep the unmerged A tokens (fixed count na - r via top-k on neg mask)
    keep_score = torch.where(merge_mask, -1.0, 1.0) * (
        1.0 + torch.arange(na, dtype=torch.float32, device=dev)[None] * 1e-6)
    keep_idx = torch.sort(topk_indices(keep_score, na - r), dim=-1).values
    kept_a = take(ae, keep_idx)
    kept_sa = torch.gather(sa, 1, keep_idx)

    merged = torch.cat([kept_a, new_b], 1).to(embeds.dtype)
    new_sizes = torch.cat([kept_sa, new_sb], 1)
    return merged, new_sizes, {"merged": r}


def tome_to_count(embeds, keep: int, *, max_r_ratio: float = 0.4):
    """Repeated ToMe passes until only ``keep`` tokens remain."""
    sizes = None
    x = embeds
    while x.shape[1] > keep:
        n = x.shape[1]
        r = min(n - keep, max(1, int((n // 2) * max_r_ratio)))
        x, sizes, _ = tome_merge(x, r, sizes=sizes)
    return x, sizes


def prune_then_merge(embeds, keep: int, *, scores=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """PuMer/FrameFusion-style hybrid.

    1) rank tokens (by ``scores`` or L2 proxy), keep the top ``keep``;
    2) each dropped token is absorbed into its most similar kept token
       (weighted mean), so information is consolidated, not discarded.
    """
    b, n, d = embeds.shape
    if scores is None:
        scores = -torch.linalg.vector_norm(embeds.float(), dim=-1)
    kidx = torch.sort(topk_indices(scores, keep), dim=-1).values
    kept = take(embeds, kidx)

    keep_mask = torch.zeros((b, n), dtype=torch.bool, device=embeds.device)
    keep_mask.scatter_(1, kidx, True)
    x = embeds.float()
    xn = unit(x)
    kn = take(xn, kidx)
    sim = torch.einsum("bnd,bkd->bnk", xn, kn)
    dst = sim.argmax(-1)                                    # [B,N]

    w = torch.where(keep_mask, 0.0, 1.0)
    add = torch.zeros((b, keep, d), dtype=torch.float32, device=embeds.device
                      ).scatter_add_(1, _rows(dst, d), x * w[..., None])
    cnt = torch.zeros((b, keep), dtype=torch.float32, device=embeds.device
                      ).scatter_add_(1, dst, w)
    merged = ((kept.float() + add) / (1.0 + cnt)[..., None]
              ).to(embeds.dtype)
    return merged, kidx, {"absorbed": int(n - keep)}
