"""Generation config of the ``repro_torch.api`` facade.

Port of ``repro.api.generation`` for this slice: the greedy and sampling
decoders and no visual-token compression. The speculative and early-exit
knobs arrive with slice 4 and the compression presets with slice 2
(ROADMAP queue A); naming them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

DECODER_NAMES = ("greedy", "sampling", "speculative", "early_exit")
PORTED_DECODERS = ("greedy", "sampling")


@dataclasses.dataclass
class GenerationConfig:
    """Everything ``LVLM.generate`` needs beyond the prompts themselves."""
    max_new_tokens: int = 32
    decoder: str = "greedy"          # greedy | sampling
    # sampling warp (ignored by the greedy decoder)
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int = -1                 # -1 = never stop on eos
    seed: int = 0
    compression: str = "none"

    def __post_init__(self):
        if self.decoder not in DECODER_NAMES:
            raise ValueError(f"unknown decoder {self.decoder!r}; "
                             f"known: {DECODER_NAMES}")
        if self.decoder not in PORTED_DECODERS:
            raise NotImplementedError(
                f"decoder {self.decoder!r} is not ported yet (ROADMAP queue "
                "A, slice 4)")
        if self.compression != "none":
            raise NotImplementedError(
                f"compression {self.compression!r} is not ported yet "
                "(ROADMAP queue A, slice 2)")
