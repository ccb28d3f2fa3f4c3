"""Decoder strategies: the four dim-4 decode paths behind one hook.

Port of ``repro.api.decoders``. Each strategy implements the engine's
decoder protocol (see ``SamplingEngineDecoder``):

    engine_decode(engine, reqs) -> {slot: [emitted tokens]}
    validate(engine)            -- run when the strategy is first resolved
    stats()                     -- strategy-specific counters for reports
    lookahead_tokens            -- extra KV positions a slot may write past
                                   the committed stream (speculative: gamma)

All four are batched slot strategies: the engine groups decode-phase slots
by each request's strategy every iteration and hands each decoder its
whole group, so one engine serves greedy, sampling, speculative and
early-exit requests together. ``speculative`` keeps per-slot draft caches
in a SECOND slot pool and runs one round per iteration over all its slots:
a fixed-shape 2-token lead extend with per-row starts and ``g - 1``
batched draft decode steps propose ``g`` tokens per slot, then ONE
per-row-start ``model.extend`` over the engine pool verifies every slot's
block (on the card both extends are the paged kernel's multi-query mode).
``early_exit`` runs each of its slots as a batch-1 view of the pool
through the host-side layer loop (a real ``break``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.decoding.early_exit import early_exit_decode_step
from repro_torch.core.decoding.sampling import sample_token
from repro_torch.core.decoding.speculative import (
    SpecStats, accept_block, acceptance_rate, batched_draft_block,
    lantern_neighbourhood_from_params)
from repro_torch.core.serving.engine import (
    SamplingEngineDecoder, _slot_get, _slot_set)


class GreedyDecoder(SamplingEngineDecoder):
    """Argmax decoding (temperature forced to 0, any batch size)."""
    name = "greedy"

    def __init__(self):
        super().__init__(greedy=True)


class SamplingDecoder(SamplingEngineDecoder):
    """Temperature / top-k / top-p sampling from EngineConfig (any batch)."""
    name = "sampling"

    def __init__(self):
        super().__init__(greedy=False)


def _shares_storage(view, whole) -> bool:
    return view.untyped_storage().data_ptr() == \
        whole.untyped_storage().data_ptr()


class EarlyExitDecoder:
    """AdaInfer-style adaptive-depth decoding inside the engine (dim 4b).

    Mixed-batch capable: each request's slot is a batch-1 VIEW of the
    pool (``_slot_get``) run through the host-side layer loop, so its
    writes, the skipped layers' back-fill included, land in the pool, and
    the exit decision is per request.
    """
    name = "early_exit"

    def __init__(self, threshold: float = 0.9, patience: int = 2,
                 min_layers: int = 2):
        self.threshold = threshold
        self.patience = patience
        self.min_layers = min_layers
        self.layers_used: List[int] = []
        self.exits = 0

    def validate(self, eng) -> None:
        if eng.compacting:
            raise ValueError("early_exit is incompatible with live KV "
                             "compaction (needs the non-windowed cache)")
        if eng.cfg.family not in ("dense", "vlm", "moe") or eng.cfg.use_mla:
            raise ValueError("early_exit targets non-MLA attention families")

    def stats(self) -> Dict:
        n = max(len(self.layers_used), 1)
        return {"layers_used": list(self.layers_used),
                "layers_used_mean": sum(self.layers_used) / n,
                "exit_rate": self.exits / n}

    def engine_decode(self, eng, reqs) -> Dict[int, List[int]]:
        emitted: Dict[int, List[int]] = {}
        cost = 0.0
        for r in reqs:
            s = r._slot
            ctx = float(eng.slot_pos[s])
            toks = torch.tensor([[int(eng.slot_last_tok[s])]],
                                device=eng.device)
            one = _slot_get(eng.pool, s)
            assert _shares_storage(one["layers"]["k"],
                                   eng.pool["layers"]["k"]), \
                "the slot cache must be a view of the pool"
            logits, _, info = early_exit_decode_step(
                eng.model, eng.params, one, toks, int(eng.slot_pos[s]),
                threshold=self.threshold, patience=self.patience,
                min_layers=self.min_layers)
            self.layers_used.append(int(info["layers_used"]))
            self.exits += int(info["exited"])
            # the virtual clock sees the layers actually run: a decode step
            # scaled by the fraction executed
            cost += (eng.ec.cost.decode_step_time(1, ctx)
                     * info["flops_frac"])
            tok = int(sample_token(eng.gen, logits,
                                   temperature=eng.ec.temperature,
                                   top_k=eng.ec.top_k,
                                   top_p=eng.ec.top_p)[0])
            eng.slot_last_tok[s] = tok
            eng.slot_pos[s] += 1
            emitted[s] = [tok]
        eng._iter_decode_cost = cost
        return emitted


class SpeculativeDecoder:
    """Draft-then-verify decoding inside the engine (dim 4a), BATCHED.

    Per engine iteration, ONE round over all speculative slots. Per-slot
    draft caches live in a second slot pool (text-only positions: the
    draft never sees the visual embeddings). Each round runs fixed-shape
    calls over the WHOLE draft pool (``batched_draft_block``), then ONE
    per-row-start ``model.extend`` over the engine pool scores every
    slot's ``[last_tok | draft block]``; Leviathan/Chen acceptance
    (optionally LANTERN-relaxed) runs per slot on its row of the logits
    and emits 1..gamma+1 tokens. ``draft=None`` self-drafts with the
    target. The virtual clock charges one (1+gamma)-token-per-slot block
    verify plus the draft's lead and gamma-1 decode steps, the latter per
    CALL, not per slot.

    LANTERN's table is the reference's ``[V, V]`` float32 similarity
    matrix on the host: fine at a smoke vocab, 92 GB at qwen2-vl's 151936.
    """
    name = "speculative"

    def __init__(self, draft=None, d_params=None, *, gamma: int = 4,
                 lantern_k: int = 0, lantern_delta: float = 0.2):
        if (draft is None) != (d_params is None):
            raise ValueError("pass draft model AND params, or neither")
        self.draft_model = draft
        self.d_params = d_params
        self.gamma = gamma
        self.lantern_k = lantern_k
        self.lantern_delta = lantern_delta
        self.stats_ = SpecStats()
        self.group_sizes: List[int] = []    # slots per round
        self._slot_req: Dict[int, object] = {}   # slot -> bound Request
        self._d_pool = None
        self._bound = False

    @property
    def lookahead_tokens(self) -> int:
        """KV slack per slot: verify writes up to gamma positions past the
        committed stream (the engine reserves it at submit)."""
        return self.gamma

    def validate(self, eng) -> None:
        if eng.compacting:
            raise ValueError("speculative verify (extend) is incompatible "
                             "with live KV compaction")
        if eng.cfg.family not in ("dense", "vlm", "moe"):
            raise ValueError("speculative needs extend(); attention "
                             "families only")

    def bound_slots(self) -> set:
        """Draft-pool slots currently bound to a live request (abort and
        retire release them via ``release_slot``)."""
        return set(self._slot_req)

    def release_slot(self, slot: int) -> None:
        """Engine lifecycle hook: drop the draft-pool binding of a slot
        whose request retired or was aborted. The next request on this
        slot re-prefills its draft row (stale tail entries stay hidden by
        causal masking until overwritten)."""
        self._slot_req.pop(slot, None)

    def stats(self) -> Dict:
        st = self.stats_
        return {"acceptance": acceptance_rate(st),
                "proposed": st.proposed, "accepted": st.accepted,
                "bonus": st.bonus, "target_calls": st.target_calls,
                "draft_calls": st.draft_calls,
                "mean_accepted_per_call": st.mean_accepted_per_call(),
                "spec_rounds": len(self.group_sizes),
                "max_slots_per_round": max(self.group_sizes, default=0)}

    def _bind(self, eng) -> None:
        if self._bound:
            if eng is not self._engine:
                raise ValueError("SpeculativeDecoder instances are "
                                 "engine-specific once bound; build one "
                                 "per Engine")
            return
        self._engine = eng
        draft = self.draft_model if self.draft_model is not None \
            else eng.model
        self._draft = draft
        self._dp = self.d_params if self.draft_model is not None \
            else eng.params
        # draft positions run text-only; headroom for the deepest round,
        # last position reserved as the inactive-row scratch
        self._d_cache_len = eng.ec.cache_len + self.gamma + 8
        self._d_pool = draft.init_cache(eng.ec.max_batch, self._d_cache_len,
                                        device=eng.device)
        self._nbhd = None
        if self.lantern_k > 1:
            self._nbhd = lantern_neighbourhood_from_params(
                eng.params, self.lantern_k)
        # cost-model scale for the draft's forward passes (virtual clock)
        self._draft_cost_ratio = (draft.cfg.active_param_count()
                                  / max(1, eng.model.cfg.active_param_count()))
        self._bound = True

    def engine_decode(self, eng, reqs) -> Dict[int, List[int]]:
        self._bind(eng)
        ec = eng.ec
        B = ec.max_batch
        draft = self._draft
        # (re)prefill draft rows for slots newly bound to a request
        for r in reqs:
            s = r._slot
            if self._slot_req.get(s) is not r:
                prompt = torch.tensor([list(r.tokens)], device=eng.device)
                _, one = draft.prefill(self._dp, {"tokens": prompt},
                                       cache_len=self._d_cache_len,
                                       last_only=True)
                _slot_set(self._d_pool, s, one)
                self.stats_.draft_calls += 1
                self._slot_req[s] = r

        # the submit-time lookahead reservation keeps every slot's verify
        # writes clear of the scratch position, so this min() normally
        # equals self.gamma
        g = self.gamma
        for r in reqs:
            g = min(g, ec.cache_len - 2 - int(eng.slot_pos[r._slot]))
        g = max(0, g)

        # --- batched draft: 2-token lead + (g-1) decode steps ------------
        d_scr = self._d_cache_len - 1
        lead2 = np.zeros((B, 2), np.int64)
        starts = np.full(B, d_scr - 1, np.int64)
        pos0 = np.full(B, d_scr, np.int64)
        for r in reqs:
            s = r._slot
            t_len = int(eng.slot_pos[s]) - int(eng.slot_nv[s])
            committed = list(r.tokens) + list(r.generated)   # text stream
            lead2[s] = committed[t_len - 1:t_len + 1]
            starts[s] = t_len - 1
            pos0[s] = t_len
        draft_toks, draft_ps, self._d_pool, _ = batched_draft_block(
            draft.extend, draft.decode_step, self._dp, self._d_pool,
            lead2, starts, pos0, gamma=g, temperature=ec.temperature,
            gen=eng.gen, scratch_pos=d_scr, stats=self.stats_,
            n_slots=len(reqs))

        # --- batched verify: ONE extend, per-row starts ------------------
        # inactive rows start at the scratch position: their block clips
        # onto it, clear of every live row (the lookahead reservation)
        blk = np.zeros((B, 1 + g), np.int64)
        vstarts = np.full(B, ec.cache_len - 1, np.int64)
        for r in reqs:
            s = r._slot
            blk[s, 0] = eng.slot_last_tok[s]
            blk[s, 1:] = draft_toks[s]
            vstarts[s] = eng.slot_pos[s]
        t_logits, eng.pool = eng.model.extend(
            eng.params, eng.pool, torch.from_numpy(blk).to(eng.device),
            torch.from_numpy(vstarts).to(eng.device))
        self.stats_.target_calls += len(reqs)
        self.stats_.proposed += g * len(reqs)
        self.group_sizes.append(len(reqs))

        # --- per-slot acceptance on row-sliced logits --------------------
        emitted_map: Dict[int, List[int]] = {}
        for r in reqs:
            s = r._slot
            emitted, n_acc, bonus, _ = accept_block(
                eng.gen, t_logits[s:s + 1],
                [int(t) for t in draft_toks[s, :g]],
                [draft_ps[j][s] for j in range(g)],
                temperature=ec.temperature,
                limit=r.max_new_tokens - len(r.generated),
                nbhd=self._nbhd, lantern_delta=self.lantern_delta)
            self.stats_.accepted += n_acc
            self.stats_.bonus += int(bonus)
            eng.slot_pos[s] += 1 + n_acc         # tok + accepted drafts
            eng.slot_last_tok[s] = emitted[-1]
            emitted_map[s] = emitted
            # a whole-block accept leaves the last accepted draft unwritten
            # in the draft cache; the next round's 2-token lead replays it

        # virtual clock: one (1+g)-token-per-slot block verify, plus the
        # draft's lead extend and g-1 decode steps charged PER CALL
        n = len(reqs)
        ctx = float(np.mean([eng.slot_pos[r._slot] for r in reqs])) \
            if reqs else 0.0
        eng._iter_decode_cost = (
            ec.cost.prefill_time((1 + g) * n)
            + self._draft_cost_ratio
            * (ec.cost.prefill_time(2 * n)
               + max(0, g - 1) * ec.cost.decode_step_time(n, ctx)))
        return emitted_map


DECODERS = {
    "greedy": GreedyDecoder,
    "sampling": SamplingDecoder,
    "speculative": SpeculativeDecoder,
    "early_exit": EarlyExitDecoder,
}


def make_decoder(name: str, gen=None, *, draft=None, d_params=None):
    """Build a decoder strategy, optionally parameterized by a
    ``GenerationConfig`` and (for speculative) a draft model."""
    if name not in DECODERS:
        raise ValueError(f"unknown decoder {name!r}; known: "
                         f"{sorted(DECODERS)}")
    if name == "early_exit":
        if gen is None:
            return EarlyExitDecoder()
        return EarlyExitDecoder(threshold=gen.exit_threshold,
                                patience=gen.exit_patience,
                                min_layers=gen.exit_min_layers)
    if name == "speculative":
        if gen is None:
            return SpeculativeDecoder(draft, d_params)
        return SpeculativeDecoder(draft, d_params, gamma=gen.gamma,
                                  lantern_k=gen.lantern_k,
                                  lantern_delta=gen.lantern_delta)
    return DECODERS[name]()
