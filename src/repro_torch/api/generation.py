"""Generation config of the ``repro_torch.api`` facade.

Port of ``repro.api.generation``: the greedy and sampling decoders and
the NAMED compression presets, so a compression sweep is a one-line loop:

    for preset in ("none", "fastv-0.5", "divprune-0.5", "tome-0.5"):
        lvlm.generate(prompts, GenerationConfig(compression=preset))

The speculative and early-exit knobs arrive with slice 4 (ROADMAP queue
A); naming those decoders raises ``NotImplementedError``. The KV presets
(``streaming-kv``, ``l2-kv``, ``<selector>-kv-<budget>``) resolve as in
the reference, but live KV compaction waits for the compacting engine
(ROADMAP A9), so a config that names one raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.configs.base import CompressionConfig
# the preset table and its grammar live in the core policy layer, so the
# engine resolves per-request names without importing the facade; the
# facade re-exports them where the reference has them
from repro_torch.core.token_compression.policy import (  # noqa: F401
    COMPRESSION_PRESETS, CompressionStrategy, resolve_compression)

DECODER_NAMES = ("greedy", "sampling", "speculative", "early_exit")
PORTED_DECODERS = ("greedy", "sampling")


@dataclasses.dataclass
class GenerationConfig:
    """Everything ``LVLM.generate`` needs beyond the prompts themselves.

    ``decoder`` and ``compression`` set the DEFAULT strategies; a request
    passed to ``LVLM.serve`` may override either per request
    (``Request.decoder`` / ``Request.compression``).
    """
    max_new_tokens: int = 32
    decoder: str = "greedy"          # greedy | sampling
    # sampling warp (ignored by the greedy decoder)
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int = -1                 # -1 = never stop on eos
    seed: int = 0
    # taxonomy dim 1: preset name, parametric name, or explicit config
    compression: Union[str, CompressionConfig] = "none"

    def __post_init__(self):
        if self.decoder not in DECODER_NAMES:
            raise ValueError(f"unknown decoder {self.decoder!r}; "
                             f"known: {DECODER_NAMES}")
        if self.decoder not in PORTED_DECODERS:
            raise NotImplementedError(
                f"decoder {self.decoder!r} is not ported yet (ROADMAP queue "
                "A, slice 4)")
        if isinstance(self.compression, (str, CompressionConfig)):
            try:
                cc = resolve_compression(self.compression)
            except ValueError:      # unknown names fail where the reference's do
                return
            if CompressionStrategy(cc).decode_budget() is not None:
                raise NotImplementedError(
                    f"compression {self.compression!r} compacts the KV "
                    "cache live, which is not ported yet (ROADMAP A9, the "
                    "compacting engine)")

    def resolved_compression(self) -> CompressionConfig:
        return resolve_compression(self.compression)
