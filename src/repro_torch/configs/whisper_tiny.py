"""Whisper-tiny (encoder-decoder audio; conv frontend stubbed). [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is a STUB per the assignment:
input_specs() supplies precomputed frame embeddings (encoder_seq x d_model).
long_500k is SKIPPED for this arch (source context <= 30s audio / 1500
frames; decoder max 448) -- see DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,               # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    encoder_seq=1500,           # 30 s at 50 frames/s after conv stride
    decoder_max_seq=448,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.with_(
    name="whisper-smoke",
    num_layers=2, encoder_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512, encoder_seq=32, decoder_max_seq=64,
    dtype="float32",
)
