"""``repro_torch.api`` -- the public inference surface of the port.

    from repro_torch.api import LVLM, GenerationConfig
    lvlm = LVLM.from_pretrained("qwen2-vl-2b")
    result = lvlm.generate(prompt, GenerationConfig(max_new_tokens=16))

Every decoder strategy (greedy | sampling | speculative | early_exit) is a
batched slot strategy; ``Request.decoder`` selects one per request and one
engine serves a mixed batch (speculative slots share each draft/verify
round). Compression is per request (``repro_torch.api.compressors``):
``Request.compression`` names a strategy resolved against the engine's
compressor registry, so one batch mixes ``none`` chat traffic with
``framefusion-0.25`` video traffic, with KV accounting on
post-compression token counts. ``LVLM.serve_cluster`` fronts N async
server replicas with a ``Router`` (routing policies, prefill / decode
roles with live KV migration, a cluster-shared prefix tier), and
``control=`` attaches the SLO-adaptive ``Controller``.
"""
from repro_torch.api.compressors import (
    CompressionStrategy, compressed_token_count, make_compressor)
from repro_torch.api.decoders import (
    DECODERS, EarlyExitDecoder, GreedyDecoder, SamplingDecoder,
    SpeculativeDecoder, make_decoder)
from repro_torch.api.generation import (
    COMPRESSION_PRESETS, DECODER_NAMES, GenerationConfig,
    resolve_compression)
from repro_torch.api.lvlm import (
    LVLM, GenerationResult, ServeResult, resolve_device)
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.serving import (CostModel, EngineConfig, PoolConfig,
                                      Request, SLO, goodput,
                                      simulate_colocated,
                                      simulate_disaggregated)
# async serving layer (re-exported for convenience, as the reference does)
from repro_torch.serving import (AdmissionConfig, AsyncLVLMServer,
                                 MetricsRegistry, TokenStream)
# cluster layer: multi-engine routing over N async server replicas
# (`LVLM.serve_cluster`)
from repro_torch.cluster import ClusterMetrics, ROUTING_POLICIES, Router
# SLO-adaptive quality control + Pareto sweeps (`control=` facade knob)
from repro_torch.control import (AdaptivePolicy, ControlConfig, ControlLevel,
                                 Controller, DEFAULT_LADDER)

__all__ = [
    "LVLM", "GenerationConfig", "GenerationResult", "ServeResult",
    "DECODERS", "DECODER_NAMES", "make_decoder", "GreedyDecoder",
    "SamplingDecoder", "SpeculativeDecoder", "EarlyExitDecoder",
    "COMPRESSION_PRESETS", "resolve_compression", "CompressionConfig",
    "CompressionStrategy", "make_compressor", "compressed_token_count",
    "EngineConfig", "Request", "SLO", "CostModel", "resolve_device",
    "AsyncLVLMServer", "TokenStream", "AdmissionConfig", "MetricsRegistry",
    "PoolConfig", "goodput", "simulate_colocated", "simulate_disaggregated",
    "Router", "ClusterMetrics", "ROUTING_POLICIES",
    "AdaptivePolicy", "ControlConfig", "ControlLevel", "Controller",
    "DEFAULT_LADDER",
]
