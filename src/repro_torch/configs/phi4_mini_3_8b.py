"""Phi-4-mini 3.8B (dense, RoPE SwiGLU GQA). [arXiv:2412.08905]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    rope_theta=1.0e4,
    tie_embeddings=True,
    sliding_window=16384,   # long-context variant
)

SMOKE_CONFIG = CONFIG.with_(
    name="phi4-mini-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, sliding_window=64, dtype="float32",
)
