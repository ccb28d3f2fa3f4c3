"""Architecture configs of the port: ``get_config(arch_id)`` / ``ARCHS``.

All ten of the reference's architectures are listed, with the same
``CONFIG`` / ``SMOKE_CONFIG`` values (``repro.configs``). The port builds
the dense, ``vlm`` and ``moe`` families, deepseek-v3's MLA included;
building rwkv6, whisper or zamba2 raises ``NotImplementedError`` naming
its ROADMAP item.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import CompressionConfig, ModelConfig, \
    ShapeConfig
from repro_torch.configs.shapes import DECODE_32K, LONG_500K, PREFILL_32K, \
    SHAPES, TRAIN_4K

_MODULES = {
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "granite-34b": "repro_torch.configs.granite_34b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

ARCHS = tuple(_MODULES)

# (arch, shape) pairs excluded from the dry-run grid, with reasons
SKIPS = {
    ("whisper-tiny", "long_500k"):
        "enc-dec audio: source context <=1500 frames, decoder max 448; "
        "524288-token decode context is architecturally meaningless",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


__all__ = [
    "ModelConfig", "ShapeConfig", "CompressionConfig",
    "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "ARCHS", "SKIPS", "get_config",
]
