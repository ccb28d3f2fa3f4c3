"""Compression policy: maps CompressionConfig -> a callable applied to the
visual token stream before (encoder-side) the backbone.

Port of ``repro.core.token_compression.policy``. Three layers live here:

  * ``COMPRESSION_PRESETS`` / ``resolve_compression`` -- the name grammar
    (ported from ``repro.api.generation``, kept here so the engine
    resolves per-request names without reaching up into the facade).
  * ``compress_visual_tokens`` -- the stateless library entry point over
    the pruners/mergers.
  * ``CompressionStrategy``    -- the strategy object the serving engine
    dispatches per request (``Request.compression``), resolved against
    the engine's compressor registry exactly like ``Request.decoder``.

Strategy protocol (duck-typed; ``CompressionStrategy`` is the config-backed
reference implementation):

    name                        -- registry key (``Request.compression``)
    encoder_active              -- bool: run ``compress_prefill`` at all?
    compress_prefill(embeds, *, query=None, scores=None)
                                -- encoder-side hook, [B,N,d] ->
                                   (compressed, kept_idx | None, info)
    compressed_token_count(n)   -- EXACT post-compression count for n
                                   visual tokens (KV accounting never runs
                                   the pruner to size a request)
    decode_budget()             -- optional KV-side hook: tokens to compact
                                   each slot to after prefill (None = no
                                   live KV compaction; the port's engine
                                   refuses a budget until the compacting
                                   engine is ported)
    kv_selector                 -- selector name for ``decode_budget``
    validate(engine)            -- optional, run on first use
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import CompressionConfig
from repro_torch.core.token_compression import merging, pruning

#: selectors the engine can run live post-prefill (attention-free;
#: attention-score selectors stay library-level -- survey §V)
LIVE_KV_SELECTORS = ("l2", "streaming")

# mergers accepted by CompressionConfig.token_merger (compress_visual_tokens)
_MERGERS = ("tome", "framefusion")

#: Named compression presets (taxonomy dims 1 and 2a). Parametric names of
#: the form "<pruner|merger>-<keep_ratio>" (e.g. "fastv-0.25") also resolve.
#: Port of ``repro.api.generation.COMPRESSION_PRESETS``.
COMPRESSION_PRESETS = {
    "none": CompressionConfig(),
    # dim 1: visual token pruning / merging before prefill
    "fastv-0.5": CompressionConfig(token_pruner="fastv", keep_ratio=0.5),
    "divprune-0.5": CompressionConfig(token_pruner="divprune",
                                      keep_ratio=0.5),
    "cdpruner-0.5": CompressionConfig(token_pruner="cdpruner",
                                      keep_ratio=0.5),
    "tome-0.5": CompressionConfig(token_merger="tome", keep_ratio=0.5),
    "framefusion-0.25": CompressionConfig(token_merger="framefusion",
                                          keep_ratio=0.25),
    # dim 2a: live KV-cache compaction in the engine (refused by the port's
    # engine until ROADMAP A9)
    "streaming-kv": CompressionConfig(kv_selector="streaming", kv_budget=64),
    "l2-kv": CompressionConfig(kv_selector="l2", kv_budget=64),
}


def resolve_compression(spec) -> CompressionConfig:
    """Resolve a preset name / parametric name / explicit config (None is
    no compression). Port of ``repro.api.generation.resolve_compression``.

    Parametric grammars beyond the preset table:
      "<pruner|merger>-<keep>"      e.g. "fastv-0.25", "tome-0.75"
      "<selector>-kv-<budget>"      e.g. "streaming-kv-128", "l2-kv-256"
    """
    if spec is None:
        return CompressionConfig()
    if isinstance(spec, CompressionConfig):
        return spec
    if spec in COMPRESSION_PRESETS:
        return COMPRESSION_PRESETS[spec]
    head, sep, tail = spec.rpartition("-")
    if sep:
        for sel in LIVE_KV_SELECTORS:
            if head == f"{sel}-kv" and tail.isdigit() and int(tail) > 0:
                return CompressionConfig(kv_selector=sel,
                                         kv_budget=int(tail))
        try:
            keep = float(tail)
        except ValueError:
            keep = None
        if keep is not None and 0.0 < keep <= 1.0:
            if head in pruning.PRUNERS:
                return CompressionConfig(token_pruner=head, keep_ratio=keep)
            if head in _MERGERS:
                return CompressionConfig(token_merger=head, keep_ratio=keep)
    known = (sorted(COMPRESSION_PRESETS)
             + [f"<{p}>-<keep>"
                for p in sorted(list(pruning.PRUNERS) + list(_MERGERS))]
             + [f"<{s}>-kv-<budget>" for s in LIVE_KV_SELECTORS])
    raise ValueError(f"unknown compression preset {spec!r}; known: {known}")


def _keep(cc: CompressionConfig, n: int) -> int:
    # Python's round() rounds half to even (round(512.5) == 512), as the
    # reference; floor(x + .5) would make compressed_token_count and the
    # compressor's output length drift apart at odd counts
    return max(1, int(round(n * cc.keep_ratio)))


def compress_visual_tokens(cc: CompressionConfig, embeds, *,
                           query=None, scores=None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                      Dict]:
    """Apply the configured encoder-side compressor.

    embeds [B,N,d]; query [B,Q,d] (text embeddings) for cross-modal
    pruners; scores [B,N] externally computed salience (e.g. encoder
    attention for PruMerge/VisionZip-style reduction).

    Returns (compressed, kept_idx or None, info).
    """
    n = embeds.shape[1]
    keep = _keep(cc, n)
    if cc.keep_ratio >= 1.0 and cc.token_merger == "none":
        return embeds, None, {"keep": n, "method": "none"}

    if cc.token_merger == "tome":
        out, _sizes = merging.tome_to_count(embeds, keep)
        return out, None, {"keep": out.shape[1], "method": "tome"}
    if cc.token_merger == "framefusion":
        out, idx, info = merging.prune_then_merge(embeds, keep, scores=scores)
        return out, idx, {"method": "prune+merge", **info}

    if cc.token_pruner == "none":
        return embeds, None, {"keep": n, "method": "none"}
    if cc.token_pruner == "fastv" and scores is None:
        # the production path never materializes attention matrices
        # (survey §V), so score-free callers (the engine) use the L2-norm
        # salience proxy: low-norm keys receive high attention [L2Compress].
        # Computed in the embeddings' own dtype: the engine hands over the
        # request's float32 embeddings before the model casts them to
        # bf16, where most of 1024 norms would tie
        scores = -torch.linalg.vector_norm(embeds, dim=-1)
    fn = pruning.PRUNERS[cc.token_pruner]
    out, idx, info = fn(embeds, keep, scores=scores, query=query)
    return out, idx, {"keep": keep, "method": cc.token_pruner, **info}


def fastv_scores_from_attention(attn_probs, visual_slice) -> torch.Tensor:
    """FastV salience from a decoder layer's attention probabilities.

    attn_probs [B, H, Sq, Sk]; visual_slice = (start, stop) of the visual
    tokens inside the key axis. Score = mean over heads and queries of the
    attention each visual key receives.
    """
    start, stop = visual_slice
    return attn_probs[..., start:stop].mean(dim=(1, 2))


def compressed_token_count(cc: CompressionConfig, n: int) -> int:
    """EXACT number of tokens ``compress_visual_tokens(cc, [*, n, d])``
    returns, computed shape-only.

    KV accounting (admission, ``Engine.kv_request_tokens``) sizes requests
    with this instead of the FULL visual count, so compressed requests
    stop over-reserving pool tokens -- and it must never have to run the
    pruner to know the answer.
    """
    keep = _keep(cc, n)
    if cc.keep_ratio >= 1.0 and cc.token_merger == "none":
        return n
    if cc.token_merger == "tome":
        # mirror merging.tome_to_count's capped-r loop (max_r_ratio=0.4)
        m = n
        while m > keep:
            m -= min(m - keep, max(1, int((m // 2) * 0.4)))
        return m
    if cc.token_merger == "framefusion":
        return keep
    if cc.token_pruner == "none":
        return n
    return keep


def _derive_name(cc: CompressionConfig) -> str:
    """Canonical strategy name for a config -- matches the parametric
    preset grammar (``resolve_compression``),
    so a default built from a config and a per-request name like
    ``"fastv-0.5"`` resolve to the SAME registry entry."""
    if cc.token_pruner != "none":
        return f"{cc.token_pruner}-{cc.keep_ratio:g}"
    if cc.token_merger != "none":
        return f"{cc.token_merger}-{cc.keep_ratio:g}"
    if cc.kv_selector in LIVE_KV_SELECTORS and cc.kv_budget > 0:
        return f"{cc.kv_selector}-kv-{cc.kv_budget}"
    return "none"


class CompressionStrategy:
    """Config-backed compression strategy (see the module docstring for
    the protocol). Wraps the pruners/mergers behind the engine's
    per-request dispatch; richer strategies duck-type the same surface."""

    def __init__(self, cc: Optional[CompressionConfig] = None,
                 name: Optional[str] = None):
        self.cc = cc if cc is not None else CompressionConfig()
        self.name = name if name is not None else _derive_name(self.cc)

    def __repr__(self) -> str:
        return f"CompressionStrategy({self.name!r})"

    # -------------------------------------------------- encoder side --
    @property
    def encoder_active(self) -> bool:
        """Whether ``compress_prefill`` does anything (the engine skips
        the hook entirely for KV-only / no-op strategies)."""
        return (self.cc.token_pruner != "none"
                or self.cc.token_merger != "none")

    @property
    def needs_query(self) -> bool:
        """Whether ``compress_prefill`` consumes the text ``query``
        embeddings -- only the cross-modal pruners do; the engine skips
        building the query for everything else."""
        return self.cc.token_pruner in ("sparsevlm", "cdpruner")

    def compress_prefill(self, embeds, *, query=None, scores=None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    Dict]:
        """Encoder-side hook: compress [B, N, d] visual embeddings before
        they enter the backbone. ``query`` [B, Q, d] carries the TEXT
        prompt embeddings so cross-modal pruners (sparsevlm / cdpruner)
        rank by instruction relevance."""
        return compress_visual_tokens(self.cc, embeds, query=query,
                                      scores=scores)

    def compressed_token_count(self, n: int) -> int:
        return compressed_token_count(self.cc, n)

    # ------------------------------------------------------- KV side --
    @property
    def kv_selector(self) -> str:
        return self.cc.kv_selector

    def decode_budget(self) -> Optional[int]:
        """KV-side hook: live post-prefill compaction budget (tokens per
        slot), or None when this strategy does not compact."""
        if self.cc.kv_selector in LIVE_KV_SELECTORS and self.cc.kv_budget:
            return self.cc.kv_budget
        return None

    def validate(self, eng) -> None:
        """First-use check against the engine (mirrors decoder
        validation): live KV compaction needs the windowed, position-exact
        cache the engine only builds when its DEFAULT strategy compacts --
        per-request overrides cannot retrofit it."""
        if self.decode_budget() is not None \
                and not getattr(eng, "compacting", False):
            raise ValueError(
                f"compression strategy {self.name!r} needs live KV "
                "compaction, but the engine was not built compacting; "
                "set the engine DEFAULT (Engine(compressor=) or the "
                "facade's GenerationConfig.compression) to a kv preset")
