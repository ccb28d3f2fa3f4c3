"""Token sampling (decode substrate).

Port of ``repro.core.decoding.sampling``: pure functions over logits
[B, V]. Randomness comes from a ``torch.Generator``; its draws are not
``jax.random``'s, so the two packages agree on the warped distributions
(``sample_probs``) and on greedy tokens, not on sampled tokens.
"""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _mask_top_k(logits, k: int):
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, -torch.inf),
                       logits)


def _mask_top_p(logits, p: float):
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # smallest set whose mass >= p (always keep the argmax); an index past
    # the end clamps to the last, as jnp.take_along_axis does
    cutoff_idx = torch.sum(cum < p, dim=-1, keepdim=True).clamp(
        max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits < cutoff, torch.full_like(logits, -torch.inf),
                       logits)


def temperature_sample(gen: Optional[torch.Generator], logits,
                       temperature: float = 1.0):
    probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[..., 0].to(torch.int32)


def sample_probs(logits, *, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0):
    """The (post-warp) categorical the sampler draws from."""
    if temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, -1), logits.shape[-1]).float()
    lg = logits / temperature
    if top_k:
        lg = _mask_top_k(lg, top_k)
    if top_p:
        lg = _mask_top_p(lg, top_p)
    return torch.softmax(lg, dim=-1)


def sample_token(gen: Optional[torch.Generator], logits, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0):
    """Dispatch: temperature<=0 -> greedy; else warped categorical."""
    if temperature <= 0.0:
        return greedy(logits)
    lg = logits
    if top_k:
        lg = _mask_top_k(lg, top_k)
    if top_p:
        lg = _mask_top_p(lg, top_p)
    return temperature_sample(gen, lg, temperature)
