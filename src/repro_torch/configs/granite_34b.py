"""Granite-34B-Code (dense llama-arch, MQA kv=1). [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,             # MQA: single KV head
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    activation="swiglu",
    rope_theta=1.0e4,
    tie_embeddings=True,
    sliding_window=16384,       # long_500k variant
)

SMOKE_CONFIG = CONFIG.with_(
    name="granite-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=1, head_dim=32,
    d_ff=512, vocab_size=512, sliding_window=64, dtype="float32",
)
