"""Snowflake Arctic (480B MoE: 128 experts top-2 + dense residual).
[hf:Snowflake/snowflake-arctic-base]

Arctic's dense-MoE hybrid: every layer computes a (small) dense residual MLP
in parallel with the routed top-2 MoE FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                  # dense-residual MLP width
    vocab_size=32000,
    activation="swiglu",
    rope_theta=1.0e4,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    sliding_window=16384,       # long_500k variant
)

SMOKE_CONFIG = CONFIG.with_(
    name="arctic-smoke",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    num_experts=4, experts_per_token=2, moe_d_ff=256,
    sliding_window=64, dtype="float32",
)
