"""The port's batched speculative and early-exit decoders in the engine
against the JAX reference (float32 smoke configs, CPU, temperature 0).

Same weights through the bridge, same prompts, visual embeddings and
arrival trace: every request's tokens are identical, TTFT/TPOT/JCT,
``decode_cost_by_group`` and ``decoder_stats`` exactly equal (the cost
model is pure arithmetic on the same schedule and the same per-round
acceptance), for a small draft and self-draft, per compression preset,
with the prefix cache, and with all four strategies mixed in one engine
under each scheduler. Also: eos inside an accepted block truncates it,
abort and retire release the draft row, the lookahead reservation keeps
every live verify block clear of the scratch slot (every round proposes
the full gamma), and the reference's refusals.
"""
import jax
import numpy as np
import pytest

from repro.api import LVLM as JLVLM
from repro.api import EngineConfig as JEngineConfig
from repro.api import GenerationConfig as JGen
from repro.api import Request as JRequest
from repro.configs import get_config as jget_config
from repro.core.serving.engine import Engine as JEngine
from repro.models.registry import build as jbuild
from repro.training.checkpoint import _flatten
from repro_torch.api import (LVLM, EngineConfig, GenerationConfig, Request)
from repro_torch.core.serving.engine import Engine
from repro_torch.core.serving.request import State
from repro_torch.models.convert import params_from_flat

GAMMA = 3
MAX_NEW = 8
SCHEDULERS = ("static", "continuous", "mlfq", "chunked")
DRAFT = dict(num_layers=1, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, head_dim=32)


def _bridge(params):
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return params_from_flat(flat, "cpu")


@pytest.fixture(scope="module")
def phi():
    j = JLVLM.from_pretrained("phi4-mini-3.8b", smoke=True)
    t = LVLM.from_pretrained("phi4-mini-3.8b", smoke=True, device="cpu")
    return j, t.with_params(_bridge(j.params))


@pytest.fixture(scope="module")
def vlm():
    j = JLVLM.from_pretrained("qwen2-vl-2b", smoke=True)
    t = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, device="cpu")
    return j, t.with_params(_bridge(j.params))


@pytest.fixture(scope="module")
def drafts(phi):
    """A 1-layer, d_model-128 draft of the phi4 smoke vocab (the reference
    tests' draft), as an ``LVLM`` of each package."""
    _, t = phi
    jm = jbuild(jget_config("phi4-mini-3.8b", smoke=True).with_(**DRAFT))
    jp = jm.init(jax.random.PRNGKey(1))
    return JLVLM(jm, jp), LVLM.from_config(t.cfg.with_(**DRAFT),
                                           device="cpu").with_params(
        _bridge(jp))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(7)
    return [list(rng.randint(1, 512, size=n)) for n in (12, 9, 15)]


def _metrics(reqs):
    return {r.rid: (list(r.generated), r.ttft(), r.tpot(), r.jct())
            for r in reqs}


def _same_stats(got: dict, want: dict):
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)


def _full_gamma(stats: dict, prefix: str = ""):
    """The lookahead reservation keeps every live verify block clear of
    the scratch slot: no round had to cut its gamma."""
    assert stats[prefix + "proposed"] == \
        GAMMA * stats[prefix + "target_calls"]


# ------------------------------------------------ batched speculative --

@pytest.mark.parametrize("kind", ["small_draft", "self_draft"])
def test_batched_spec_matches_reference(phi, drafts, prompts, kind):
    j, t = phi
    jd, td = drafts if kind == "small_draft" else (None, None)
    kw = dict(decoder="speculative", temperature=0.0,
              max_new_tokens=MAX_NEW, gamma=GAMMA)
    jr = j.generate(prompts, JGen(**kw), draft=jd)
    tr = t.generate(prompts, GenerationConfig(**kw), draft=td)
    assert _metrics([r.request for r in tr]) == \
        _metrics([r.request for r in jr])
    _same_stats(tr[0].stats, jr[0].stats)
    assert tr[0].stats["max_slots_per_round"] >= 2
    _full_gamma(tr[0].stats)
    greedy = t.generate(prompts, GenerationConfig(max_new_tokens=MAX_NEW))
    assert [r.tokens for r in tr] == [r.tokens for r in greedy]
    stream = list(t.generate_stream(prompts[0], GenerationConfig(**kw),
                                    draft=td))
    assert stream == tr[0].tokens


@pytest.mark.parametrize("preset,kind", [
    ("none", "self_draft"), ("fastv-0.5", "self_draft"),
    ("divprune-0.5", "self_draft"), ("tome-0.5", "self_draft"),
    ("fastv-0.5", "small_draft")])
def test_batched_spec_per_preset_matches_reference(vlm, drafts, preset,
                                                   kind):
    """A 2-slot VLM batch per compression preset: draft positions are
    text-only (``slot_pos - slot_nv``, the post-compression count). The
    small draft is the text model of the same vocab."""
    j, t = vlm
    jd, td = drafts if kind == "small_draft" else (None, None)
    rng = np.random.RandomState(11)
    ps = [list(rng.randint(1, t.cfg.vocab_size, size=n)) for n in (10, 7)]
    ves = [rng.randn(t.cfg.num_visual_tokens, t.cfg.d_model
                     ).astype(np.float32) * 0.02 for _ in ps]
    kw = dict(decoder="speculative", temperature=0.0, max_new_tokens=6,
              gamma=GAMMA, compression=preset)
    jr = j.generate(ps, JGen(**kw), visual_embeds=ves, draft=jd)
    tr = t.generate(ps, GenerationConfig(**kw), visual_embeds=ves, draft=td)
    assert _metrics([r.request for r in tr]) == \
        _metrics([r.request for r in jr])
    _same_stats(tr[0].stats, jr[0].stats)
    assert tr[0].stats["max_slots_per_round"] >= 2
    _full_gamma(tr[0].stats)
    greedy = t.generate(ps, GenerationConfig(max_new_tokens=6,
                                             compression=preset),
                        visual_embeds=ves)
    assert [r.tokens for r in tr] == [r.tokens for r in greedy]


def test_spec_with_prefix_cache_matches_reference(phi):
    j, t = phi
    rng = np.random.RandomState(17)
    shared = list(rng.randint(1, 512, size=16))
    ps = [shared + list(rng.randint(1, 512, size=4)) for _ in range(3)]
    kw = dict(decoder="speculative", temperature=0.0, max_new_tokens=6,
              gamma=GAMMA)
    ec = dict(max_batch=3, cache_len=64, prefix_cache=True, prefix_block=8)
    jr = j.generate(ps, JGen(**kw), engine_cfg=JEngineConfig(**ec))
    tr = t.generate(ps, GenerationConfig(**kw), engine_cfg=EngineConfig(**ec))
    assert _metrics([r.request for r in tr]) == \
        _metrics([r.request for r in jr])
    _same_stats(tr[0].stats, jr[0].stats)
    assert tr[0].stats["prefix_hit_tokens"] > 0
    base = t.generate(ps, GenerationConfig(**kw))
    assert [r.tokens for r in tr] == [r.tokens for r in base]


# ------------------------------------------------------- mixed serve --

@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_mixed_strategies_match_reference(phi, drafts, prompts, scheduler):
    """ONE engine serves greedy, sampling (at temperature 0), speculative
    (a small draft) and early-exit requests under each scheduler: tokens,
    clocks, per-group decode cost and the prefixed decoder stats equal
    the reference's, and each request equals its greedy stream."""
    j, t = phi
    jd, td = drafts
    decs = ["greedy", "speculative", "early_exit", "speculative",
            "sampling", None]

    def reqs(R):
        return [R(rid=i, tokens=list(prompts[i % 3]), max_new_tokens=MAX_NEW,
                  decoder=d, arrival=0.001 * i)
                for i, d in enumerate(decs)]
    kw = dict(max_batch=4, cache_len=64, scheduler=scheduler, chunk_size=8,
              token_budget=24, temperature=0.0)
    gkw = dict(decoder="greedy", temperature=0.0, max_new_tokens=MAX_NEW,
               gamma=GAMMA)
    jrep = j.serve(reqs(JRequest), JEngineConfig(**kw), gen=JGen(**gkw),
                   draft=jd)
    trep = t.serve(reqs(Request), EngineConfig(**kw),
                   gen=GenerationConfig(**gkw), draft=td)
    assert _metrics(trep.requests) == _metrics(jrep.requests)
    _same_stats(trep.stats, jrep.stats)
    assert trep.stats["finished"] == len(decs)
    assert "early_exit/exit_rate" in trep.stats
    _full_gamma(trep.stats, "speculative/")
    greedy = t.generate([prompts[i % 3] for i in range(3)],
                        GenerationConfig(max_new_tokens=MAX_NEW))
    for r in trep.requests:
        assert r.generated == greedy[r.rid % 3].tokens, r.rid


@pytest.mark.parametrize("threshold,patience,min_layers", [
    (1.1, 2, 2), (0.0, 0, 1)])
def test_early_exit_engine_matches_reference(vlm, threshold, patience,
                                             min_layers):
    """Early exit on a VLM batch: never firing (1.1, equal to greedy) and
    firing at layer 1 with the back-fill (0.0)."""
    j, t = vlm
    rng = np.random.RandomState(5)
    ps = [list(rng.randint(1, t.cfg.vocab_size, size=n)) for n in (8, 11)]
    ves = [rng.randn(t.cfg.num_visual_tokens, t.cfg.d_model
                     ).astype(np.float32), None]
    kw = dict(decoder="early_exit", temperature=0.0, max_new_tokens=6,
              exit_threshold=threshold, exit_patience=patience,
              exit_min_layers=min_layers)
    jr = j.generate(ps, JGen(**kw), visual_embeds=ves)
    tr = t.generate(ps, GenerationConfig(**kw), visual_embeds=ves)
    assert _metrics([r.request for r in tr]) == \
        _metrics([r.request for r in jr])
    _same_stats(tr[0].stats, jr[0].stats)
    if threshold > 1:
        assert tr[0].stats["exit_rate"] == 0.0
        assert set(tr[0].stats["layers_used"]) == {t.cfg.num_layers}
        greedy = t.generate(ps, GenerationConfig(max_new_tokens=6),
                            visual_embeds=ves)
        assert [r.tokens for r in tr] == [r.tokens for r in greedy]
    else:
        assert tr[0].stats["exit_rate"] == 1.0
        assert set(tr[0].stats["layers_used"]) == {1}


# -------------------------------------------------------- edge cases --

def test_eos_mid_accepted_block_truncates(phi, prompts):
    j, t = phi
    ref = t.generate(prompts[0], GenerationConfig(max_new_tokens=MAX_NEW))
    k = next(i for i in range(1, GAMMA)
             if ref.tokens.index(ref.tokens[i]) == i)
    eos = ref.tokens[k]
    kw = dict(decoder="speculative", temperature=0.0,
              max_new_tokens=MAX_NEW, gamma=GAMMA, eos_id=eos)
    out = t.generate(prompts[0], GenerationConfig(**kw))
    assert out.tokens == ref.tokens[:k + 1]
    assert eos not in out.tokens[:-1] and len(out.tokens) < MAX_NEW
    assert out.tokens == j.generate(prompts[0], JGen(**kw)).tokens


def _spec_engine(cls, lvlm, ec_cls, draft=None):
    """An engine of either package with a greedy default and a registered
    speculative strategy (gamma = GAMMA)."""
    if cls is Engine:
        from repro_torch.api.decoders import SpeculativeDecoder
    else:
        from repro.api.decoders import SpeculativeDecoder
    dec = SpeculativeDecoder(None if draft is None else draft.model,
                             None if draft is None else draft.params,
                             gamma=GAMMA)
    return cls(lvlm.model, lvlm.params,
               ec_cls(max_batch=3, cache_len=64, decoder="greedy",
                      temperature=0.0),
               decoders={"speculative": dec}), dec


def test_abort_and_retire_release_draft_rows(phi, drafts, prompts):
    """The draft row is bound while its request decodes and released on
    abort and on retire; KV reservations (lookahead included) return to
    the baseline -- step by step as the reference."""
    for (cls, R, ec_cls, lvlm, d) in ((Engine, Request, EngineConfig,
                                       phi[1], drafts[1]),
                                      (JEngine, JRequest, JEngineConfig,
                                       phi[0], drafts[0])):
        eng, dec = _spec_engine(cls, lvlm, ec_cls, d)
        reqs = [R(rid=i, tokens=list(p), max_new_tokens=MAX_NEW,
                  decoder="speculative" if i < 2 else "greedy")
                for i, p in enumerate(prompts)]
        base = eng.kv_committed_tokens()
        for r in reqs:
            eng.submit(r)
        assert all(r.lookahead == GAMMA for r in reqs[:2])
        while not dec.bound_slots():
            eng.step()
        eng.step()
        assert dec.bound_slots() == {reqs[0]._slot, reqs[1]._slot}
        slot = reqs[0]._slot
        assert eng.abort(reqs[0].rid)
        assert slot not in dec.bound_slots()
        assert eng.slot_req[slot] is None
        eng.run()
        assert dec.bound_slots() == set()            # retire released it
        assert eng.kv_committed_tokens() == base == 0
        assert len(eng.finished) == 2 and reqs[0].aborted


def test_capacity_margin_and_refusals(phi, prompts):
    """A speculative request reserves gamma lookahead at submit (one that
    fits greedily may not fit speculatively); speculative and early exit
    refuse a compacting engine, as the reference's decoders."""
    _, t = phi
    eng = t.serve([], EngineConfig(max_batch=1, cache_len=32,
                                   decoder="greedy")).engine
    eng.submit(Request(rid=0, tokens=list(range(1, 24)), max_new_tokens=8))
    tight = Request(rid=1, tokens=list(range(1, 24)), max_new_tokens=8,
                    decoder="speculative")
    with pytest.raises(ValueError):
        eng.submit(tight)
    assert tight.lookahead == 4                     # the default gamma
    assert eng.kv_request_tokens(Request(rid=2, tokens=[1] * 10,
                                         max_new_tokens=6,
                                         decoder="speculative")) == 32
    for dec in ("speculative", "early_exit"):
        with pytest.raises(ValueError):
            t.generate(prompts[0], GenerationConfig(
                decoder=dec, max_new_tokens=4, compression="streaming-kv"))
        ceng = t.serve([], EngineConfig(max_batch=2, cache_len=64),
                       gen=GenerationConfig(compression="streaming-kv")
                       ).engine
        with pytest.raises(ValueError):
            ceng.submit(Request(rid=3, tokens=[1, 2], decoder=dec))


def test_state_after_speculative_round(phi, prompts):
    """After a round the slot's position, last token and text stream
    agree: slot_pos = prompt + generated - 1, and the last emitted token
    is the next round's first verify token."""
    _, t = phi
    eng, _ = _spec_engine(Engine, t, EngineConfig)
    r = Request(rid=0, tokens=list(prompts[1]), max_new_tokens=MAX_NEW,
                decoder="speculative")
    eng.submit(r)
    while r.state != State.DONE:
        eng.step()
        if r.state == State.DECODE:
            assert eng.slot_pos[r._slot] == len(r.tokens) + \
                len(r.generated) - 1
            assert eng.slot_last_tok[r._slot] == r.generated[-1]
