"""Compression strategies for the ``repro_torch.api`` facade -- the survey
dim-1 mirror of ``repro_torch.api.decoders``. Port of
``repro.api.compressors``.

  * ``CompressionStrategy`` (from the core policy layer) is the
    config-backed implementation of the strategy protocol: an
    encoder-side ``compress_prefill(embeds, query=..., scores=...)`` hook
    and an exact ``compressed_token_count`` for KV accounting.
  * the Engine keeps a compressor registry (``Engine(compressors=...)``);
    ``Request.compression`` names a strategy per request and resolves
    exactly like ``Request.decoder`` -- unknown names fall back to the
    preset/parametric grammar (``"fastv-0.5"``, ``"framefusion-0.25"``,
    ...), so one batch serves a video request under aggressive pruning
    next to an uncompressed chat request.
  * ``GenerationConfig.compression`` is sugar: the facade builds the named
    default strategy and registers it with the engine.

    lvlm = LVLM.from_pretrained("qwen2-vl-2b")
    reqs = [Request(rid=0, tokens=chat, visual_embeds=img),
            Request(rid=1, tokens=vid, visual_embeds=frames,
                    compression="framefusion-0.25")]
    rep = lvlm.serve(reqs, gen=GenerationConfig(compression="none"))
    rep.engine.compression_stats()["framefusion-0.25"]
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.configs.base import CompressionConfig
from repro_torch.core.token_compression.policy import (
    CompressionStrategy, compressed_token_count, resolve_compression)

__all__ = ["CompressionStrategy", "compressed_token_count",
           "make_compressor"]


def make_compressor(spec: Union[str, CompressionConfig,
                                CompressionStrategy, None] = None, *,
                    name: Optional[str] = None) -> CompressionStrategy:
    """Build a compression strategy from a preset name, parametric name,
    explicit ``CompressionConfig``, or pass an existing strategy through.

    A string spec keeps its literal name as the registry key (so the
    request-side name ``"fastv-0.5"`` and the strategy registered for a
    default of ``"fastv-0.5"`` unify); configs derive a canonical name in
    the same grammar.
    """
    if isinstance(spec, CompressionStrategy):
        return spec
    if spec is not None and not isinstance(spec, (str, CompressionConfig)):
        if hasattr(spec, "compress_prefill"):     # duck-typed custom strategy
            return spec
        raise TypeError(f"not a compression strategy/spec: {spec!r}")
    cc = resolve_compression(spec)
    if name is None and isinstance(spec, str):
        name = spec
    return CompressionStrategy(cc, name=name)
