"""Video token compression (survey dim 1-2): spatiotemporal merging and
dynamic, multi-granular, task-aware compression.

Port of ``repro.core.token_compression.video``. Inputs are frame-patch
embeddings [B, F, P, d] (F frames, P patches/frame) from the stubbed
frontend.

  * temporal_merge     -- Chat-UniVi/HoliTom-style: cluster temporally
                          adjacent similar frames, average their patches.
  * llama_vid_compress -- LLaMA-VID: 2 tokens per frame (context + content).
  * dycoke_ratio       -- DyCoke: per-window dynamic compression ratio from
                          frame-difference complexity.
  * dynamic_compress   -- dynamic pipeline: complexity-adaptive per-frame
                          patch budgets (Dynamic-VLM / FastVID flavor).
  * framefusion        -- similarity-then-importance prune+merge across the
                          flattened spatiotemporal token stream.

A static video ties on every frame: the top-k cuts go through
``topk_indices``, which keeps JAX's lower-index-first order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.token_compression.merging import prune_then_merge
from repro_torch.core.token_compression.pruning import take, topk_indices


def _frame_feats(video):
    """[B,F,P,d] -> normalized per-frame mean feature [B,F,d] (f32)."""
    f = video.float().mean(2)
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-6)


def frame_similarity(video) -> torch.Tensor:
    """Cosine similarity between consecutive frames: [B, F-1]."""
    f = _frame_feats(video)
    return torch.einsum("bfd,bfd->bf", f[:, :-1], f[:, 1:])


def temporal_merge(video, num_segments: int) -> Tuple[torch.Tensor, Dict]:
    """Merge F frames into ``num_segments`` contiguous segments.

    Segment boundaries are placed at the ``num_segments-1`` LOWEST
    consecutive-frame similarities (scene changes), then patches are
    averaged within each segment -- the global-optimization view of
    HoliTom vs. fixed-stride pooling.

    Returns ([B, num_segments, P, d], info).
    """
    b, f, p, d = video.shape
    sim = frame_similarity(video)                           # [B,F-1]
    cut_idx = topk_indices(-sim, num_segments - 1)          # lowest sim
    # boundary mask: frame i starts a new segment if cut at i-1
    starts = torch.zeros((b, f), dtype=torch.long, device=video.device)
    starts.scatter_(1, cut_idx + 1, 1)
    starts[:, 0] = 1
    seg_id = torch.cumsum(starts, dim=1) - 1                # [B,F] in [0,S)

    x = video.float()
    seg_sum = torch.zeros((b, num_segments, p, d), dtype=torch.float32,
                          device=video.device).scatter_add_(
        1, seg_id[:, :, None, None].expand(b, f, p, d), x)
    seg_cnt = torch.zeros((b, num_segments), dtype=torch.float32,
                          device=video.device).scatter_add_(
        1, seg_id, torch.ones((b, f), dtype=torch.float32,
                              device=video.device))
    out = seg_sum / seg_cnt[..., None, None]
    return out.to(video.dtype), {"segments": num_segments}


def llama_vid_compress(video, query=None) -> Tuple[torch.Tensor, Dict]:
    """LLaMA-VID: each frame -> [context token, content token].

    context token = query-conditioned attention pool over patches (mean
    pool without query); content token = plain mean pool. Output
    [B, F*2, d]. A bf16 query meets float32 patches here: both are
    promoted to float32 first, as the reference casts them.
    """
    b, f, p, d = video.shape
    x = video.float()
    content = x.mean(2)                                     # [B,F,d]
    if query is not None:
        q = query.float().mean(1)                           # [B,d]
        att = torch.softmax(
            torch.einsum("bd,bfpd->bfp", q, x) / (d ** 0.5), -1)
        context = torch.einsum("bfp,bfpd->bfd", att, x)
    else:
        context = content
    out = torch.stack([context, content], 2).reshape(b, f * 2, d)
    return out.to(video.dtype), {"tokens_per_frame": 2}


def dycoke_ratio(video, *, min_ratio=0.1, max_ratio=1.0) -> torch.Tensor:
    """DyCoke: dynamic per-frame keep ratio from temporal complexity.

    Static scenes (high consecutive similarity) compress hard; motion
    keeps more. Returns keep ratio per frame [B, F] in [min, max].
    """
    complexity = 1.0 - frame_similarity(video)              # [B,F-1]
    complexity = torch.cat([complexity[:, :1], complexity], 1)   # [B,F]
    # ABSOLUTE complexity (clipped), not per-video max-normalized: a fully
    # static video must compress hard everywhere
    c = torch.clamp(complexity, 0.0, 1.0)
    return min_ratio + (max_ratio - min_ratio) * c


def dynamic_compress(video, token_budget: int) -> Tuple[torch.Tensor, Dict]:
    """Complexity-adaptive compression to a fixed total ``token_budget``.

    Per-frame budgets proportional to DyCoke complexity; within each frame
    the top-|budget_f| patches by distance-from-frame-mean are kept (static
    background drops first). Fixed output shape [B, token_budget, d]:
    frames are ranked patch-wise, then a global top-k over weighted
    saliency picks exactly ``token_budget`` tokens.
    """
    b, f, p, d = video.shape
    x = video.float()
    ratios = dycoke_ratio(video)                            # [B,F]
    mean = x.mean(2, keepdim=True)
    sal = torch.linalg.vector_norm(x - mean, dim=-1)        # [B,F,P]
    sal = sal / (sal.amax(-1, keepdim=True) + 1e-6)
    weighted = (sal * ratios[..., None]).reshape(b, f * p)
    idx = torch.sort(topk_indices(weighted, token_budget), dim=-1).values
    out = take(x.reshape(b, f * p, d), idx)
    # ratios_mean stays a device tensor (reading it would sync the host)
    return out.to(video.dtype), {"budget": token_budget,
                                 "ratios_mean": ratios.mean()}


def framefusion(video, keep: int) -> Tuple[torch.Tensor, Dict]:
    """FrameFusion: merge near-duplicate spatiotemporal tokens, prune the
    unimportant remainder, down to ``keep`` tokens."""
    b, f, p, d = video.shape
    flat = video.reshape(b, f * p, d)
    x = flat.float()
    mean = x.mean(1, keepdim=True)
    importance = torch.linalg.vector_norm(x - mean, dim=-1)  # distance = info
    merged, _, info = prune_then_merge(flat, keep, scores=importance)
    return merged, {"keep": keep, **info}
