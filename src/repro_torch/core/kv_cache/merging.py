"""KV cache merging (survey dim 2a-iii): training-free intra-layer merging.

Port of ``repro.core.kv_cache.merging``:

  * d2o_merge   -- D2O: evicted keys/values are absorbed into their most
                   similar retained entry when cosine similarity clears a
                   threshold (otherwise truly discarded).
  * chai_cluster-- CHAI: cluster attention heads whose attention patterns
                   correlate; compute one representative head per cluster
                   and share it (returns head->cluster map + reduced KV).

The reference's scatter-adds (``.at[...].add``) are ``scatter_add_`` here;
on CUDA their summation order is not fixed (atomics). ``chai_cluster`` is
host numpy, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _take(x, idx):
    """x [B,S,H,D], idx [B,Bud] -> [B,Bud,H,D]."""
    return torch.gather(x, 1, idx[:, :, None, None].expand(
        -1, -1, x.shape[2], x.shape[3]))


def d2o_merge(k, v, keep_idx, *, threshold: float = 0.5
              ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """k,v [B,S,H,D]; keep_idx [B,Bud] sorted. Returns merged (k',v').

    Evicted entries with cosine(sim to nearest kept key) >= threshold are
    merged (mean) into that kept entry; others are dropped (true eviction).
    """
    b, s, h, d = k.shape
    bud = keep_idx.shape[1]
    keep_idx = keep_idx.long()
    kk, vv = _take(k, keep_idx), _take(v, keep_idx)           # [B,Bud,H,D]

    keep_mask = torch.zeros((b, s), dtype=torch.bool, device=k.device)
    keep_mask.scatter_(1, keep_idx, True)
    kf = k.float()
    kn = kf / (torch.linalg.vector_norm(kf, dim=-1, keepdim=True) + 1e-6)
    kkn = _take(kn, keep_idx)
    # per-head similarity of every token to every kept token
    sim = torch.einsum("bshd,bthd->bhst", kn, kkn)            # [B,H,S,Bud]
    best, dst = sim.max(-1)                                   # [B,H,S]
    mergeable = (~keep_mask[:, None]) & (best >= threshold)

    w = mergeable.float()
    kf_t = kf.movedim(2, 1)                                   # [B,H,S,D]
    vf_t = v.float().movedim(2, 1)
    idx_d = dst[..., None].expand(-1, -1, -1, d)
    add_k = torch.zeros((b, h, bud, d), device=k.device).scatter_add_(
        2, idx_d, kf_t * w[..., None])
    add_v = torch.zeros((b, h, bud, d), device=k.device).scatter_add_(
        2, idx_d, vf_t * w[..., None])
    cnt = torch.zeros((b, h, bud), device=k.device).scatter_add_(2, dst, w)

    k_out = (kk.float().movedim(2, 1) + add_k) / (1.0 + cnt)[..., None]
    v_out = (vv.float().movedim(2, 1) + add_v) / (1.0 + cnt)[..., None]
    merged_frac = w.sum() / torch.clamp((~keep_mask).sum() * h, min=1)
    return (k_out.movedim(1, 2).to(k.dtype), v_out.movedim(1, 2).to(v.dtype),
            {"merged_frac": merged_frac})


def chai_cluster(attn, num_clusters: int) -> Tuple[np.ndarray, Dict]:
    """CHAI: cluster heads by attention-pattern correlation (host-side).

    attn [B,H,Sq,S] -> head_to_cluster [H] int; representative = first
    member. Simple greedy agglomeration on the head-head correlation of
    flattened attention maps (k-medoid-ish, deterministic).
    """
    a = torch.as_tensor(attn).detach().float().cpu().numpy()
    h = a.shape[1]
    flat = a.transpose(1, 0, 2, 3).reshape(h, -1)
    flat = (flat - flat.mean(1, keepdims=True))
    flat /= (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-6)
    corr = flat @ flat.T                                    # [H,H]

    assignment = -np.ones(h, int)
    reps = []
    order = np.argsort(-corr.sum(1))                        # central heads first
    for head in order:
        if assignment[head] >= 0:
            continue
        if len(reps) < num_clusters:
            reps.append(head)
            assignment[head] = len(reps) - 1
        else:
            assignment[head] = int(np.argmax([corr[head, r] for r in reps]))
    # assign leftovers (none expected, but safe)
    for head in range(h):
        if assignment[head] < 0:
            assignment[head] = int(np.argmax([corr[head, r] for r in reps]))
    within = float(np.mean([corr[i, reps[assignment[i]]] for i in range(h)]))
    return assignment, {"reps": reps, "within_corr": within}


def chai_shared_attention(q, k, v, assignment, reps):
    """Compute attention only for representative heads, share across the
    cluster. q,k,v [B,S,H,D] -> out [B,S,H,D]; softmax over full S."""
    b, s, h, d = q.shape
    reps = torch.as_tensor(np.asarray(reps), dtype=torch.long,
                           device=q.device)
    assignment = torch.as_tensor(np.asarray(assignment), dtype=torch.long,
                                 device=q.device)
    qr, kr = q[:, :, reps], k[:, :, reps]                   # [B,S,R,D]
    scores = torch.einsum("bqrd,bkrd->brqk", qr.float(),
                          kr.float()) / (d ** 0.5)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, -1e30))
    p = torch.softmax(scores, -1)                           # [B,R,Sq,Sk]
    p_full = p[:, assignment]                               # [B,H,Sq,Sk]
    out = torch.einsum("bhqk,bkhd->bqhd", p_full, v.float())
    return out.to(q.dtype)
