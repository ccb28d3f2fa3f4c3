"""Multimodal speculative decoding (survey dim 4a): draft-then-verify.

Port of ``repro.core.decoding.speculative``. A LANGUAGE-ONLY draft
proposes ``gamma`` tokens over the text stream (it never sees the visual
embeddings; Gagrani et al.), the multimodal target scores
``[last token | draft block]`` in ONE ``model.extend``, and
Leviathan/Chen acceptance (optionally LANTERN-relaxed over a cosine-kNN
neighbourhood of the unembedding) keeps a prefix of the block plus a
resampled or bonus token.

Randomness goes through an explicit ``torch.Generator`` in place of the
reference's JAX key; its draws are not ``jax.random``'s, so the packages
agree on drawn tokens only at temperature 0, where the acceptance is
deterministic (``u = 0.5``, ``sample_probs`` one-hot) and the rejection
resample puts all but ~V * 1e-30 of its mass on the target's argmax.

On the card the target's block verify is a scalar-start extend (the flash
kernel) in ``speculative_generate`` and a per-row-start extend (the paged
kernel's multi-query mode) in the engine's batched verify; the draft's
steps are decode steps (the paged kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.decoding.sampling import sample_probs


@dataclasses.dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    bonus: int = 0
    target_calls: int = 0
    draft_calls: int = 0

    @property
    def tokens_emitted(self) -> int:
        return self.accepted + self.bonus + self.rejected_resamples

    @property
    def rejected_resamples(self) -> int:
        # every target call emits at least one token (resample or bonus)
        return self.target_calls - self.bonus

    def mean_accepted_per_call(self) -> float:
        return (self.accepted + self.target_calls) / max(self.target_calls, 1)


def acceptance_rate(stats: SpecStats) -> float:
    return stats.accepted / max(stats.proposed, 1)


def _lantern_neighbourhood(embed_w: np.ndarray, k: int):
    """Precompute cosine-kNN token neighbourhoods in unembedding space
    (host numpy, as the reference: a [V, V] float32 similarity matrix)."""
    w = np.asarray(embed_w, np.float32)
    w = w / (np.linalg.norm(w, axis=1, keepdims=True) + 1e-6)
    sims = w @ w.T
    return np.argsort(-sims, axis=1)[:, :k]        # [V, k], col 0 == self


def lantern_neighbourhood_from_params(t_params, k: int):
    """Build the LANTERN kNN table from a target param tree (embed/unembed)."""
    ew = t_params["embed"]
    w = ew["unembed"].t() if "unembed" in ew else ew["tok"]
    return _lantern_neighbourhood(w.detach().float().cpu().numpy(), k)


def _draw(gen: Optional[torch.Generator], pd, temperature: float):
    """The draft's token from its warped distribution ``pd`` [B, V]:
    argmax at temperature 0, else a categorical draw over
    log(pd + 1e-30), as the reference."""
    if temperature <= 0:
        return torch.argmax(pd, -1)
    return torch.multinomial(pd + 1e-30, 1, generator=gen)[:, 0]


def draft_block(d_extend, d_decode, d_params, d_cache, lead_toks, start, *,
                gamma: int, temperature: float, gen,
                stats: Optional[SpecStats] = None):
    """Draft ``gamma`` tokens autoregressively.

    ``lead_toks`` (list[int], len >= 1) are the committed tokens the draft
    cache has not scored yet, ending with the current last token; they are
    scored in ONE ``extend`` at position ``start`` before drafting begins
    (the lead back-fills the draft-cache hole left by a fully-accepted
    block). Returns (draft_toks, draft_ps, d_cache, gen); shared by
    ``speculative_generate`` and the engine-side strategy in
    ``repro_torch.api.decoders``.
    """
    device = d_params["embed"]["tok"].device
    draft_toks, draft_ps = [], []
    cur = torch.tensor([lead_toks], dtype=torch.long, device=device)
    d_len = start + len(lead_toks)
    for g in range(gamma):
        if g == 0:
            lg, d_cache = d_extend(d_params, d_cache, cur, start)
            lg = lg[:, -1]
        else:
            lg, d_cache = d_decode(d_params, d_cache, cur,
                                   torch.tensor([d_len - 1], device=device))
        if stats is not None:
            stats.draft_calls += 1
        pd = sample_probs(lg, temperature=temperature)
        nxt = _draw(gen, pd, temperature)
        draft_toks.append(int(nxt[0]))
        draft_ps.append(pd[0])
        cur = nxt[:, None]
        d_len += 1
    return draft_toks, draft_ps, d_cache, gen


def batched_draft_block(d_extend, d_decode, d_params, d_pool, lead2, starts,
                        pos0, *, gamma: int, temperature: float, gen,
                        scratch_pos: int, stats: Optional[SpecStats] = None,
                        n_slots: int = 1):
    """Draft ``gamma`` tokens for MANY slot rows in fixed-shape calls (the
    engine's batched counterpart of ``draft_block``).

    ``lead2 [B,2]`` holds, per row, the last two committed text tokens
    ``[c_{t-1}, c_t]`` and ``starts [B] = t-1``: rewriting position ``t-1``
    with the token it already holds is a KV no-op, so ONE fixed-shape
    2-token ``extend`` (per-row starts: the paged kernel's multi-query
    mode on the card) covers both the post-full-accept draft-cache hole
    and the ordinary case. ``pos0 [B] = t``; draft token ``j`` is scored at
    ``t+1+j`` by one batched ``decode_step`` per step. Inactive rows are
    routed to the draft pool's scratch tail (``scratch_pos``).

    Returns ``(draft_toks [B, gamma] np.int32, draft_ps: gamma x [B, V],
    d_pool, gen)``.
    """
    device = d_params["embed"]["tok"].device
    B = lead2.shape[0]
    draft_toks = np.zeros((B, gamma), np.int32)
    draft_ps = []
    if gamma <= 0:
        return draft_toks, draft_ps, d_pool, gen
    lg, d_pool = d_extend(d_params, d_pool,
                          torch.as_tensor(np.asarray(lead2, np.int64),
                                          device=device),
                          torch.as_tensor(np.asarray(starts, np.int64),
                                          device=device))
    lg = lg[:, -1]
    pos0 = torch.as_tensor(np.asarray(pos0, np.int64), device=device)
    cur = None
    for g in range(gamma):
        if g > 0:
            pos = torch.clamp(pos0 + g, max=scratch_pos)
            lg, d_pool = d_decode(d_params, d_pool, cur, pos)
        if stats is not None:
            stats.draft_calls += n_slots
        pd = sample_probs(lg, temperature=temperature)
        nxt = _draw(gen, pd, temperature)
        draft_toks[:, g] = nxt.cpu().numpy()
        draft_ps.append(pd)
        cur = nxt[:, None]
    return draft_toks, draft_ps, d_pool, gen


def accept_block(gen, t_logits, draft_toks, draft_ps, *, temperature: float,
                 limit: int, nbhd=None, lantern_delta: float = 0.2):
    """Leviathan/Chen acceptance (+ optional LANTERN relaxation) over ONE
    verified block.

    ``t_logits`` [1, gamma+1, V] are the target logits for
    [committed_tok, draft_0, ..., draft_{gamma-1}]; ``limit`` caps how many
    tokens this round may emit. Returns (emitted, n_accepted, bonus, gen).
    Each draft token reads its probabilities on the host (one sync each):
    the acceptance is a host loop, as the reference's.
    """
    gamma = len(draft_toks)
    emitted = []
    n_acc = 0
    emitted_reject = False
    for g in range(gamma):
        pt = sample_probs(t_logits[:, g], temperature=temperature)[0]
        pd = draft_ps[g]
        x = draft_toks[g]
        p_acc_num = float(pt[x])
        if nbhd is not None:
            # LANTERN: aggregate target mass over the latent
            # neighbourhood of x, capped by the TV budget delta
            idx = torch.as_tensor(np.asarray(nbhd[x]), device=pt.device)
            extra = float(pt[idx].sum()) - float(pt[x])
            p_acc_num = min(p_acc_num + max(extra, 0.0),
                            p_acc_num + lantern_delta)
        ratio = p_acc_num / max(float(pd[x]), 1e-30)
        u = float(torch.rand((), generator=gen,
                             device=gen.device if gen is not None else None)
                  ) if temperature > 0 else 0.5
        if ratio >= 1.0 or u < ratio:
            n_acc += 1
            emitted.append(x)
            if len(emitted) >= limit:
                break
        else:
            # rejection: resample from norm(max(0, p_t - p_d))
            resid = torch.clamp(pt - pd, min=0.0)
            tot = float(resid.sum())
            if tot <= 1e-9:
                resid = pt
                tot = float(resid.sum())
            emitted.append(int(torch.multinomial(resid / tot + 1e-30, 1,
                                                 generator=gen)[0]))
            emitted_reject = True
            break
    bonus = False
    if not emitted_reject and len(emitted) < limit and n_acc == gamma:
        # whole block accepted: bonus token from the last target logits
        pt = sample_probs(t_logits[:, gamma], temperature=temperature)[0]
        y = (int(torch.argmax(pt)) if temperature <= 0
             else int(torch.multinomial(pt + 1e-30, 1, generator=gen)[0]))
        emitted.append(y)
        bonus = True
    return emitted, n_acc, bonus, gen


def speculative_generate(target, draft, t_params, d_params, prompt,
                         *, max_new_tokens: int, gamma: int = 4,
                         temperature: float = 0.0,
                         lantern_k: int = 0, lantern_delta: float = 0.2,
                         visual_embeds=None,
                         gen: Optional[torch.Generator] = None,
                         cache_margin: int = 8):
    """Generate with draft-then-verify. Returns (tokens [T], SpecStats).

    target/draft: Model instances (same vocab), on the device of their
    params. ``prompt`` [S] token ids. ``visual_embeds`` [Nv, d_target]
    goes ONLY to the target (language-only drafting).
    """
    device = t_params["embed"]["tok"].device
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    stats = SpecStats()
    prompt_list = [int(t) for t in prompt]
    prompt_t = torch.tensor([prompt_list], dtype=torch.long, device=device)
    s = len(prompt_list)
    nv = 0 if visual_embeds is None else int(visual_embeds.shape[0])
    budget = s + nv + max_new_tokens + gamma + cache_margin

    # --- prefill both models (only the last position's logits are read) -
    t_batch = {"tokens": prompt_t}
    if visual_embeds is not None:
        t_batch["visual_embeds"] = torch.as_tensor(
            np.asarray(visual_embeds), device=device)[None]
    t_logits, t_cache = target.prefill(t_params, t_batch, cache_len=budget,
                                       last_only=True)
    _, d_cache = draft.prefill(d_params, {"tokens": prompt_t},
                               cache_len=budget, last_only=True)
    stats.target_calls += 1
    stats.draft_calls += 1

    nbhd = None
    if lantern_k > 1:
        nbhd = lantern_neighbourhood_from_params(t_params, lantern_k)

    out = []
    # sample the first token from the prefill logits
    p0 = sample_probs(t_logits[:, -1], temperature=temperature)
    tok = int(_draw(gen, p0, temperature)[0])
    out.append(tok)

    t_len = s          # text tokens scored so far (target pos = nv + t_len)
    d_valid = s        # draft-cache committed prefix (see draft_block lead)
    while len(out) < max_new_tokens:
        # --- draft gamma tokens (the lead replays what the draft misses)
        committed = prompt_list + out             # text stream, pos i
        lead = committed[d_valid:t_len + 1]
        draft_toks, draft_ps, d_cache, gen = draft_block(
            draft.extend, draft.decode_step, d_params, d_cache, lead,
            d_valid, gamma=gamma, temperature=temperature, gen=gen,
            stats=stats)

        # --- verify: ONE target pass over [tok, draft block] -----------
        block = torch.tensor([[tok] + draft_toks], dtype=torch.long,
                             device=device)
        t_logits, t_cache = target.extend(t_params, t_cache, block,
                                          nv + t_len)
        stats.target_calls += 1
        stats.proposed += gamma

        emitted, n_acc, bonus, gen = accept_block(
            gen, t_logits, draft_toks, draft_ps, temperature=temperature,
            limit=max_new_tokens - len(out), nbhd=nbhd,
            lantern_delta=lantern_delta)
        out.extend(emitted)
        stats.accepted += n_acc
        stats.bonus += int(bonus)

        t_len += 1 + n_acc          # target consumed tok + accepted drafts
        # after a whole-block accept the last accepted draft was never
        # written to the draft cache: the next round's lead replays it
        d_valid = t_len - (1 if (gamma > 0 and n_acc == gamma) else 0)
        tok = out[-1]

    return out[:max_new_tokens], stats
