"""Zamba2-1.2B (hybrid: Mamba2 backbone + shared attention block). [arXiv:2411.15242]

38 Mamba2 layers with ONE shared (parameter-tied) attention+MLP block
invoked every `attn_layer_period` layers, concatenating the original
embedding with the residual stream (Zamba's design). long_500k runs
natively: SSM state is O(1); the shared attention block uses a sliding
window over its own KV.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    activation="gelu",
    norm="layernorm",
    rope_theta=1.0e4,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_layer_period=6,        # shared attn block after every 6 mamba layers
    sliding_window=4096,        # window for the shared attention block
)

SMOKE_CONFIG = CONFIG.with_(
    name="zamba2-smoke",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, ssm_state_dim=16, ssm_head_dim=32,
    attn_layer_period=2, sliding_window=64, dtype="float32",
)
