"""Qwen2-VL-2B (VLM backbone; M-RoPE, dynamic resolution). [arXiv:2409.12191]

The ViT frontend is a stub: callers supply precomputed patch embeddings
(num_visual_tokens x d_model, before the MLP projector).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    activation="swiglu",
    rope_theta=1.0e6,
    use_mrope=True,
    mrope_sections=(16, 24, 24),
    num_visual_tokens=1024,       # default dynamic-resolution budget
    tie_embeddings=True,
    sliding_window=16384,         # long-context variant
)

SMOKE_CONFIG = CONFIG.with_(
    name="qwen2-vl-smoke",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512, num_visual_tokens=16,
    mrope_sections=(8, 12, 12), sliding_window=64, dtype="float32",
)
