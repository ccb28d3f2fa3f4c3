"""Nemotron-4 340B (dense, GQA, squared-ReLU MLP). [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,               # d_model / num_heads
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    norm="layernorm",
    rope_theta=1.0e4,
    sliding_window=16384,       # long_500k variant
)

SMOKE_CONFIG = CONFIG.with_(
    name="nemotron-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, sliding_window=64, dtype="float32",
)
