"""Generation config of the ``repro_torch.api`` facade.

Port of ``repro.api.generation``: the four decoders (greedy, sampling,
speculative with its gamma / LANTERN knobs, early exit with its
threshold / patience / min_layers) and the NAMED compression presets, so
a compression sweep is a one-line loop:

    for preset in ("none", "fastv-0.5", "divprune-0.5", "tome-0.5"):
        lvlm.generate(prompts, GenerationConfig(compression=preset))

The KV presets (``streaming-kv``, ``l2-kv``, ``<selector>-kv-<budget>``)
serve as in the reference: as the default they make the engine compacting
(which the speculative and early-exit decoders refuse, as the reference's).
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
PORTED_DECODERS = DECODER_NAMES


@dataclasses.dataclass
class GenerationConfig:
    """Everything ``LVLM.generate`` needs beyond the prompts themselves.

    ``decoder`` and ``compression`` set the DEFAULT strategies; a request
    passed to ``LVLM.serve`` may override either per request
    (``Request.decoder`` / ``Request.compression``). Speculative slots
    reserve ``gamma`` extra KV positions each (the verify's lookahead) on
    top of ``prompt + max_new_tokens``.
    """
    max_new_tokens: int = 32
    decoder: str = "greedy"          # greedy | sampling | speculative | early_exit
    # sampling warp (ignored by the greedy decoder)
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int = -1                 # -1 = never stop on eos
    seed: int = 0
    # taxonomy dim 1: preset name, parametric name, or explicit config
    compression: Union[str, CompressionConfig] = "none"
    # speculative decoding (dim 4a); the draft model itself is passed to
    # generate(..., draft=...) -- None means self-draft
    gamma: int = 4
    lantern_k: int = 0               # >1 enables LANTERN relaxed acceptance
    lantern_delta: float = 0.2
    # early exit (dim 4b)
    exit_threshold: float = 0.9
    exit_patience: int = 2
    exit_min_layers: int = 2

    def __post_init__(self):
        if self.decoder not in DECODER_NAMES:
            raise ValueError(f"unknown decoder {self.decoder!r}; "
                             f"known: {DECODER_NAMES}")

    @property
    def effective_temperature(self) -> float:
        """Temperature the DEFAULT strategy samples at (greedy pins 0)."""
        return 0.0 if self.decoder == "greedy" else self.temperature

    def resolved_compression(self) -> CompressionConfig:
        return resolve_compression(self.compression)

    def with_(self, **kw) -> "GenerationConfig":
        return dataclasses.replace(self, **kw)
