"""Architecture configs of the port: ``get_config(arch_id)`` / ``ARCHS``.

Only the architectures the port can build are listed (the dense and
``vlm`` families); the others arrive with their model families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
}

ARCHS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


__all__ = ["ModelConfig", "ARCHS", "get_config"]
