"""Model registry: ``build(cfg)`` -> Model (assembly in transformer.py)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Model

_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def build(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(cfg)
