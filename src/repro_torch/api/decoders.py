"""Decoder strategies behind the engine's decode hook.

Port of ``repro.api.decoders`` for this slice: the greedy and sampling
adapters, which reuse the engine's fixed-shape decode step. The
speculative and early-exit strategies come with slice 4.
"""
from __future__ import annotations

from repro_torch.core.serving.engine import SamplingEngineDecoder


class GreedyDecoder(SamplingEngineDecoder):
    """Argmax decoding (temperature forced to 0, any batch size)."""
    name = "greedy"

    def __init__(self):
        super().__init__(greedy=True)


class SamplingDecoder(SamplingEngineDecoder):
    """Temperature / top-k / top-p sampling from EngineConfig (any batch)."""
    name = "sampling"

    def __init__(self):
        super().__init__(greedy=False)


DECODERS = {"greedy": GreedyDecoder, "sampling": SamplingDecoder}


def make_decoder(name: str):
    """Build a decoder strategy by name."""
    if name in ("speculative", "early_exit"):
        raise NotImplementedError(
            f"decoder {name!r} is not ported yet (ROADMAP queue A, slice 4)")
    if name not in DECODERS:
        raise ValueError(f"unknown decoder {name!r}; known: "
                         f"{sorted(DECODERS)}")
    return DECODERS[name]()
