"""``repro_torch.api`` -- the public inference surface of the port.

    from repro_torch.api import LVLM, GenerationConfig
    lvlm = LVLM.from_pretrained("qwen2-vl-2b")
    result = lvlm.generate(prompt, GenerationConfig(max_new_tokens=16))
"""
from repro_torch.api.decoders import (
    DECODERS, GreedyDecoder, SamplingDecoder, make_decoder)
from repro_torch.api.generation import DECODER_NAMES, GenerationConfig
from repro_torch.api.lvlm import (
    LVLM, GenerationResult, ServeResult, resolve_device)
from repro_torch.core.serving import CostModel, EngineConfig, Request, SLO

__all__ = [
    "LVLM", "GenerationConfig", "GenerationResult", "ServeResult",
    "DECODERS", "DECODER_NAMES", "make_decoder", "GreedyDecoder",
    "SamplingDecoder", "EngineConfig", "Request", "SLO", "CostModel",
    "resolve_device",
]
