"""The port's windowed model paths, compacting engine and prefix cache
against the JAX reference (qwen2-vl smoke, float32, CPU).

Windowed prefill, extend and decode logits (the paths the kernels now
serve: flash over the fresh prompt and over an unwrapped ring, the paged
kernel's masked mode) agree within 1e-4 of the logit scale, as the port's
model tests require. The compacting engine, under all four schedulers with
per-request KV budgets, gives identical greedy tokens and exactly equal
TTFT/TPOT/JCT, and each compacted slot keeps the reference's positions
(``slot_pos`` identical) with K/V within the same 1e-4. The prefix-cache
engine (hits, true-LRU eviction that skips pinned entries, an abort that
releases its pin) matches the reference's tokens, clock and prefix stats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import EngineConfig as JEngineConfig
from repro.api import GenerationConfig as JGen
from repro.api import Request as JRequest
from repro.api.compressors import make_compressor as jmake_compressor
from repro.core.serving.engine import Engine as JEngine
from repro.models.registry import build as jbuild
from repro.training.checkpoint import _flatten
from repro_torch.api import (LVLM, EngineConfig, GenerationConfig, Request,
                             make_compressor)
from repro_torch.core.serving.engine import Engine
from repro_torch.models.convert import params_from_flat
from repro_torch.models.registry import build as tbuild

TOL = 1e-4
SCHEDULERS = ("static", "continuous", "mlfq", "chunked")


@pytest.fixture(scope="module")
def pair():
    j = JLVLM.from_pretrained("qwen2-vl-2b", smoke=True)
    t = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, device="cpu")
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    return j, t.with_params(params_from_flat(flat, "cpu"))


def _close(j, t):
    j, t = np.asarray(j), t.numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= TOL * scale, np.abs(j - t).max() / scale


def _metrics(reqs):
    return {r.rid: (list(r.generated), r.ttft(), r.tpot(), r.jct())
            for r in reqs}


# ------------------------------------------------------------- model --

def test_windowed_prefill_extend_decode_logits(pair):
    """A 48-row ring (the compacting engine's model: sliding_window =
    cache_len): prefill, an extend that fits, decodes, an extend that wraps
    the ring (the CPU-only plain path) and decodes over the wrapped ring;
    then ``window > 0`` decode on a plain cache."""
    j, t = pair
    jm = jbuild(j.cfg.with_(sliding_window=48))
    tm = tbuild(t.cfg.with_(sliding_window=48))
    jp, tp = j.params, t.params
    rng = np.random.default_rng(0)
    cfg = t.cfg
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    ve = rng.standard_normal((2, cfg.num_visual_tokens, cfg.d_model)
                             ).astype(np.float32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "visual_embeds": jnp.asarray(ve)},
                        cache_len=48, windowed=True)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "visual_embeds": torch.from_numpy(ve)},
                        cache_len=48, windowed=True)
    _close(jl, tl)
    s = 20 + cfg.num_visual_tokens                       # 36

    def both_extend(n, start):
        nonlocal jc
        ext = rng.integers(0, cfg.vocab_size, (2, n)).astype(np.int32)
        je, jc = jm.extend(jp, jc, jnp.asarray(ext), jnp.int32(start))
        te, _ = tm.extend(tp, tc, torch.from_numpy(ext).long(), start)
        _close(je, te)

    def both_decode(pos, **kw):
        nonlocal jc
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                jnp.asarray(np.array(pos, np.int32)), **kw)
        td, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                               torch.tensor(pos), **kw)
        _close(jd, td)

    both_extend(6, s)                                    # rows 36..41
    both_decode([42, 42], windowed=True)
    both_decode([43, 43], windowed=True)
    both_extend(6, 44)                                   # wraps: 44..49
    both_decode([50, 50], windowed=True)                 # over the ring
    np.testing.assert_array_equal(np.asarray(jc["layers"]["slot_pos"]),
                                  tc["layers"]["slot_pos"].numpy())
    _close(jc["layers"]["k"], tc["layers"]["k"])
    # window > 0 on a plain (non-ring) cache
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=48)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        cache_len=48)
    both_decode([20, 17], window=8)


# -------------------------------------------------------- compacting --

# per-request strategies on a compacting engine (default streaming-kv-16):
# two selectors at four budgets, no compaction, and an encoder-side pruner
KV_MIX = ("streaming-kv-16", "l2-kv-12", "none", "fastv-0.5",
          "streaming-kv-24", "l2-kv-8")


def _kv_requests(R, cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 12, 7, 14, 10, 8)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) for _ in KV_MIX]
    return [R(rid=i, tokens=p, max_new_tokens=5, visual_embeds=v,
              arrival=0.002 * i, compression=c)
            for i, (p, v, c) in enumerate(zip(prompts, ves, KV_MIX))]


def _record_compactions(monkeypatch, cls, to_np):
    """Wrap ``cls._compact_slot`` to record each compacted slot's k, v and
    slot_pos right after compaction, keyed by request id."""
    seen = {}
    orig = cls._compact_slot

    def rec(self, slot, selector, budget):
        orig(self, slot, selector, budget)
        lc = self.pool["layers"]
        seen[self.slot_req[slot].rid] = (
            selector, budget, *(to_np(lc[n][:, slot])
                                for n in ("k", "v", "slot_pos")))
    monkeypatch.setattr(cls, "_compact_slot", rec)
    return seen


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_compacting_engine_matches_reference(pair, scheduler, monkeypatch):
    j, t = pair
    jseen = _record_compactions(monkeypatch, JEngine, np.asarray)
    tseen = _record_compactions(monkeypatch, Engine,
                                lambda x: x.clone().numpy())
    kw = dict(max_batch=3, cache_len=48, scheduler=scheduler, chunk_size=8,
              token_budget=24)
    jrep = j.serve(_kv_requests(JRequest, t.cfg), JEngineConfig(**kw),
                   gen=JGen(decoder="greedy", compression="streaming-kv-16"))
    trep = t.serve(_kv_requests(Request, t.cfg), EngineConfig(**kw),
                   gen=GenerationConfig(decoder="greedy",
                                        compression="streaming-kv-16"))
    assert trep.engine.compacting and trep.engine.windowed
    assert trep.engine.cfg.sliding_window == 48
    assert len(trep.requests) == len(KV_MIX)
    assert _metrics(trep.requests) == _metrics(jrep.requests)
    assert trep.engine.compression_stats() == jrep.engine.compression_stats()
    for k in ("virtual_time_s", "iterations", "ttft_mean", "tpot_mean"):
        assert trep.stats[k] == jrep.stats[k], k
    # the four kv strategies compacted, each to its own budget
    assert sorted(tseen) == sorted(jseen) == [0, 1, 4, 5]
    for rid, (sel, budget, jk, jv, jsp) in jseen.items():
        tsel_, tbud, tk, tv, tsp = tseen[rid]
        assert (tsel_, tbud) == (sel, budget)
        np.testing.assert_array_equal(tsp, jsp)
        assert ((tsp >= 0).sum(-1) == budget).all()
        _close(jk, torch.from_numpy(tk))
        _close(jv, torch.from_numpy(tv))


def test_generate_with_a_kv_preset_matches_reference(pair):
    j, t = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, t.cfg.vocab_size, n).tolist()
               for n in (70, 90)]
    for preset in ("streaming-kv", "l2-kv"):
        jr = j.generate(prompts, JGen(max_new_tokens=6, decoder="greedy",
                                      compression=preset))
        tr = t.generate(prompts, GenerationConfig(
            max_new_tokens=6, decoder="greedy", compression=preset))
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
        assert _metrics([r.request for r in tr]) == \
            _metrics([r.request for r in jr])


def test_refusals_that_stay(pair):
    """Prefix reuse with compaction, and a per-request kv strategy on an
    engine that does not compact, raise ValueError as in the reference."""
    j, t = pair
    for eng_cls, model, params, ec_cls, mk in (
            (JEngine, j.model, j.params, JEngineConfig, jmake_compressor),
            (Engine, t.model, t.params, EngineConfig, make_compressor)):
        with pytest.raises(ValueError, match="prefix reuse"):
            eng_cls(model, params, ec_cls(prefix_cache=True),
                    compressor=mk("streaming-kv"))
        eng = eng_cls(model, params, ec_cls(max_batch=1, cache_len=64))
        with pytest.raises(ValueError, match="not built compacting"):
            eng.submit((JRequest if eng_cls is JEngine else Request)(
                rid=0, tokens=[1, 2, 3], max_new_tokens=2,
                compression="l2-kv"))


# ------------------------------------------------------------ prefix --

def _prefix_requests(R, cfg, seed=1):
    """Three system prompts of 24 tokens; each request adds its own tail.
    prefix_cap 2 forces LRU evictions; arrivals spread so later requests
    find earlier prompts cached."""
    rng = np.random.default_rng(seed)
    sys = [rng.integers(0, cfg.vocab_size, 24).tolist() for _ in range(3)]
    order = (0, 0, 1, 0, 2, 1, 0, 2, 2, 1)
    return [R(rid=i, tokens=sys[s] + rng.integers(
                0, cfg.vocab_size, 3 + i % 4).tolist(),
              max_new_tokens=4, arrival=0.01 * i)
            for i, s in enumerate(order)]


def _prefix_state(eng):
    return ([(v, len(toks)) for v, toks in eng._prefix],
            sorted((k[0], len(k[1]), n) for k, n in eng._prefix_pins.items()),
            eng.prefix_hit_tokens, eng.prefix_total_tokens)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_prefix_cache_engine_matches_reference(pair, scheduler):
    j, t = pair
    kw = dict(max_batch=2, cache_len=48, scheduler=scheduler, chunk_size=8,
              token_budget=24, prefix_cache=True, prefix_block=8,
              prefix_cap=2)
    jrep = j.serve(_prefix_requests(JRequest, t.cfg), JEngineConfig(**kw),
                   gen=JGen(decoder="greedy"))
    trep = t.serve(_prefix_requests(Request, t.cfg), EngineConfig(**kw),
                   gen=GenerationConfig(decoder="greedy"))
    assert _metrics(trep.requests) == _metrics(jrep.requests)
    for k in ("prefix_hit_tokens", "prefix_token_hit_rate", "virtual_time_s",
              "iterations"):
        assert trep.stats[k] == jrep.stats[k], k
    assert trep.stats["prefix_hit_tokens"] > 0
    assert _prefix_state(trep.engine) == _prefix_state(jrep.engine)
    assert not trep.engine._prefix_pins          # every pin released


def test_prefix_hit_equals_a_cold_prefill(pair):
    """A hit installs a clone of the cached rows: greedy tokens equal those
    of the same serve without the prefix cache, after the hit's source
    slot was reused by another request."""
    _, t = pair
    kw = dict(max_batch=1, cache_len=48, scheduler="continuous")
    gen = GenerationConfig(decoder="greedy")
    hot = t.serve(_prefix_requests(Request, t.cfg),
                  EngineConfig(**kw, prefix_cache=True, prefix_block=8), gen)
    cold = t.serve(_prefix_requests(Request, t.cfg), EngineConfig(**kw), gen)
    assert hot.stats["prefix_hit_tokens"] > 0
    assert {r.rid: r.generated for r in hot.requests} == \
        {r.rid: r.generated for r in cold.requests}


def test_prefix_abort_releases_its_pin(pair):
    """Drive both engines step by step; abort a request that holds a
    prefix pin mid-decode: the pin goes, LRU may evict the entry again,
    and the rest of the run matches the reference."""
    j, t = pair
    kw = dict(max_batch=2, cache_len=48, scheduler="continuous",
              prefix_cache=True, prefix_block=8, prefix_cap=2)
    jeng = JEngine(j.model, j.params, JEngineConfig(**kw))
    teng = Engine(t.model, t.params, EngineConfig(**kw))
    jreqs = _prefix_requests(JRequest, t.cfg)
    treqs = _prefix_requests(Request, t.cfg)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    victim = None
    for _ in range(200):
        jmore, tmore = jeng.step(), teng.step()
        assert jmore == tmore
        assert _prefix_state(teng) == _prefix_state(jeng)
        if victim is None:
            pinned = [r for r in treqs if getattr(r, "_prefix_pin", None)
                      and r.state.value == "decode"]
            if pinned:
                victim = pinned[0].rid
                assert teng.abort(victim) and jeng.abort(victim)
                assert all(getattr(r, "_prefix_pin", None) is None
                           for r in treqs if r.rid == victim)
                assert _prefix_state(teng) == _prefix_state(jeng)
        if not tmore:
            break
    assert victim is not None
    assert _metrics(teng.finished) == _metrics(jeng.finished)
    assert [r.rid for r in teng.aborted] == [victim]
    assert not teng._prefix_pins and not jeng._prefix_pins
