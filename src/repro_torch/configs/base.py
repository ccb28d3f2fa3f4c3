"""Model and compression configuration for the PyTorch port.

Copies of ``repro.configs.base.ModelConfig`` and ``CompressionConfig``
(the port imports nothing of the JAX package). The fields, defaults and
derived properties are the reference's, so a config built here describes
the same network as the reference config of the same name.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ------------------------------------------------------------
    name: str
    family: str                      # dense | moe | vlm | ssm | hybrid | audio
    source: str = ""                 # citation for the config numbers

    # transformer core ------------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    activation: str = "swiglu"       # swiglu | relu2 | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False

    # positional ------------------------------------------------------------
    rope_theta: float = 1.0e4
    use_mrope: bool = False          # Qwen2-VL multimodal RoPE (3 sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2

    # MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 -> d_ff)
    first_k_dense_layers: int = 0
    dense_residual: bool = False
    router_aux_loss_coef: float = 1.0e-2

    # MLA (DeepSeek-V3 multi-head latent attention) ----------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (Mamba2 / RWKV6) ------------------------------------------------
    ssm_state_dim: int = 0
    ssm_conv_dim: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2

    # hybrid (Zamba2) ---------------------------------------------------------
    attn_layer_period: int = 0

    # encoder-decoder (Whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0
    decoder_max_seq: int = 0

    # multimodal frontend stub ---------------------------------------------
    num_visual_tokens: int = 0       # patch embeds supplied by the caller
    projector: str = "mlp"           # mlp | perceiver
    num_latents: int = 64

    # long-context -----------------------------------------------------
    sliding_window: int = 0          # 0 = full attention; >0 = ring-buffer window

    # numerics --------------------------------------------------------------
    dtype: str = "bfloat16"
    logits_softcap: float = 0.0
    weight_quant: str = "none"       # none | int8_ffn

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Selects taxonomy-dimension-1/2 features for a serving run (a copy
    of ``repro.configs.base.CompressionConfig``: same fields, defaults)."""
    # visual token compression (dim 1)
    token_pruner: str = "none"       # none|fastv|sparsevlm|l2|divprune|cdpruner|pyramiddrop
    token_merger: str = "none"       # none|tome|framefusion
    keep_ratio: float = 1.0          # fraction of visual tokens kept
    prune_layer: int = 2             # FastV: drop after this decoder layer
    # KV cache (dim 2)
    kv_selector: str = "none"        # none|snapkv|h2o|streaming|l2
    kv_budget: int = 0               # tokens retained (0 = unlimited)
    kv_budget_policy: str = "uniform"   # uniform|pyramid|adaptive
    kv_merger: str = "none"          # none|d2o
    # decoding (dim 4)
    speculative: bool = False
    draft_len: int = 4
    early_exit_threshold: float = 0.0   # 0 = disabled
