"""RWKV-6 "Finch" 3B (attention-free, data-dependent decay). [arXiv:2404.05892]

No KV cache: decode state is O(1) per layer (time-mix shift + per-head wkv
state). The survey's attention-score-based compression is inapplicable
(DESIGN.md §3); L2/diversity pruners still apply pre-backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=40,              # d_model / ssm_head_dim
    num_kv_heads=0,            # attention-free
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    activation="relu2",        # RWKV channel-mix uses squared ReLU
    norm="layernorm",
    ssm_state_dim=64,          # wkv state is (heads, 64, 64)
    ssm_head_dim=64,
)

SMOKE_CONFIG = CONFIG.with_(
    name="rwkv6-smoke",
    num_layers=2, d_model=128, num_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, ssm_state_dim=32, ssm_head_dim=32,
    dtype="float32",
)
