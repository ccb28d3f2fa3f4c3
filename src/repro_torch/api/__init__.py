"""``repro_torch.api`` -- the public inference surface of the port.

    from repro_torch.api import LVLM, GenerationConfig
    lvlm = LVLM.from_pretrained("qwen2-vl-2b")
    result = lvlm.generate(prompt, GenerationConfig(max_new_tokens=16))

Compression is per request (``repro_torch.api.compressors``):
``Request.compression`` names a strategy resolved against the engine's
compressor registry, so one batch mixes ``none`` chat traffic with
``framefusion-0.25`` video traffic, with KV accounting on
post-compression token counts.
"""
from repro_torch.api.compressors import (
    CompressionStrategy, compressed_token_count, make_compressor)
from repro_torch.api.decoders import (
    DECODERS, GreedyDecoder, SamplingDecoder, make_decoder)
from repro_torch.api.generation import (
    COMPRESSION_PRESETS, DECODER_NAMES, GenerationConfig,
    resolve_compression)
from repro_torch.api.lvlm import (
    LVLM, GenerationResult, ServeResult, resolve_device)
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.serving import CostModel, EngineConfig, Request, SLO

__all__ = [
    "LVLM", "GenerationConfig", "GenerationResult", "ServeResult",
    "DECODERS", "DECODER_NAMES", "make_decoder", "GreedyDecoder",
    "SamplingDecoder",
    "COMPRESSION_PRESETS", "resolve_compression", "CompressionConfig",
    "CompressionStrategy", "make_compressor", "compressed_token_count",
    "EngineConfig", "Request", "SLO", "CostModel", "resolve_device",
]
