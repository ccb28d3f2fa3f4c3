"""Mistral-Large-Instruct-2407 (123B dense). [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    activation="swiglu",
    rope_theta=1.0e6,
    # long_500k runs via the sliding-window variant (see DESIGN.md §4).
    sliding_window=16384,
)

SMOKE_CONFIG = CONFIG.with_(
    name="mistral-large-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, sliding_window=64, dtype="float32",
)
