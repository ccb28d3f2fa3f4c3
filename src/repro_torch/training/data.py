"""Synthetic multimodal data pipeline.

Copy of ``repro.training.data`` (numpy, so a batch is bit-identical to the
reference's). Deterministic, seekable token/patch streams so training is
reproducible and checkpoint-resumable (the stream is a pure function of
(seed, step)). Text tokens follow a Zipfian unigram draw with induced
bigram structure so the loss actually falls during the example runs
(pure uniform noise would give a flat log(V) floor). Visual/audio
"frontends" follow the assignment carve-out: the pipeline emits
precomputed patch/frame embeddings of the right shape instead of running
a ViT/conv codec.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticDataConfig:
    batch: int = 4
    seq_len: int = 64
    seed: int = 0
    zipf_a: float = 1.2
    bigram_shift: int = 7          # next ~ (prev * shift) % V mixing


def _zipf_probs(v: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


def make_batch(cfg: ModelConfig, dc: SyntheticDataConfig, step: int
               ) -> Dict[str, np.ndarray]:
    """Batch for ``step`` (pure function -- seekable)."""
    rng = np.random.RandomState((dc.seed * 1_000_003 + step) % (2 ** 31))
    v = cfg.vocab_size
    probs = _zipf_probs(v, dc.zipf_a)
    b, s = dc.batch, dc.seq_len
    # semi-structured stream: half the positions follow a deterministic
    # bigram map, half are fresh zipf draws -> learnable but not trivial
    base = rng.choice(v, size=(b, s), p=probs)
    tokens = base.copy()
    for t in range(1, s):
        follow = rng.rand(b) < 0.5
        tokens[:, t] = np.where(
            follow, (tokens[:, t - 1] * dc.bigram_shift + 1) % v, base[:, t])
    out: Dict[str, np.ndarray] = {"tokens": tokens.astype(np.int32)}
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    out["labels"] = labels.astype(np.int32)
    out["loss_mask"] = np.ones((b, s), np.float32)
    out["loss_mask"][:, -1] = 0.0
    if cfg.family == "vlm":
        nv = cfg.num_visual_tokens
        out["visual_embeds"] = rng.randn(b, nv, cfg.d_model).astype(
            np.float32) * 0.02
    if cfg.family == "audio":
        out["frames"] = rng.randn(b, cfg.encoder_seq, cfg.d_model).astype(
            np.float32) * 0.02
    return out


def synthetic_batches(cfg: ModelConfig, dc: SyntheticDataConfig,
                      start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, dc, step)
        step += 1
