"""DeepSeek-V3 (671B MoE, MLA, 1 shared + 256 routed top-8). [arXiv:2412.19437]

The assignment's "GQA kv=128" reflects MLA's 128 effective heads; the cache
is the compressed latent (kv_lora_rank + rope dim), which is itself a
KV-cache-compression technique in the survey's dimension 2.
The paper's MTP (multi-token prediction) head is not built here, nor in
the reference: speculative decoding on this config self-drafts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,            # MLA: all heads share the latent cache
    head_dim=128,
    d_ff=18432,                  # dense-layer FFN width
    vocab_size=129280,
    activation="swiglu",
    rope_theta=1.0e4,
    # MoE
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,               # assigned d_ff=2048 = per-expert width
    first_k_dense_layers=3,
    # MLA
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    sliding_window=16384,        # long_500k variant
)

SMOKE_CONFIG = CONFIG.with_(
    name="deepseek-v3-smoke",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=512, vocab_size=512,
    num_experts=4, experts_per_token=2, num_shared_experts=1, moe_d_ff=128,
    first_k_dense_layers=1,
    q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32, sliding_window=64, dtype="float32",
)
