"""The port's engine and facade against the JAX reference.

Same weights (through the bridge), same prompts, visual embeddings and
arrival trace: greedy tokens must be identical, and the virtual-clock
TTFT/TPOT/JCT exactly equal (``CostModel`` is pure arithmetic on the same
schedule), under every scheduler. Sampling is held equal on the warped
distributions (``sample_probs``), not on drawn tokens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import EngineConfig as JEngineConfig
from repro.api import GenerationConfig as JGen
from repro.api import Request as JRequest
from repro.core.decoding import sampling as jsampling
from repro.training.checkpoint import _flatten
from repro_torch.api import LVLM, EngineConfig, GenerationConfig, Request
from repro_torch.core.decoding import sampling as tsampling
from repro_torch.core.serving.request import State
from repro_torch.models.convert import params_from_flat


@pytest.fixture(scope="module")
def pair():
    j = JLVLM.from_pretrained("qwen2-vl-2b", smoke=True)
    t = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, device="cpu")
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    return j, t.with_params(params_from_flat(flat, "cpu"))


def _workload(cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 30, 14, 5)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32), None, None,
           rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32)]
    return prompts, ves


def _metrics(reqs):
    return {r.rid: (list(r.generated), r.ttft(), r.tpot(), r.jct())
            for r in reqs}


def test_generate_matches_reference(pair):
    j, t = pair
    prompts, ves = _workload(t.cfg)
    jr = j.generate(prompts, JGen(max_new_tokens=6, decoder="greedy"),
                    visual_embeds=ves)
    tr = t.generate(prompts, GenerationConfig(max_new_tokens=6,
                                              decoder="greedy"),
                    visual_embeds=ves)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert _metrics([r.request for r in tr]) == \
        _metrics([r.request for r in jr])
    for key in ("finished", "tokens", "ttft_mean", "tpot_mean", "jct_mean",
                "iterations", "virtual_time_s"):
        assert tr[0].stats[key] == jr[0].stats[key], key
    single = t.generate(prompts[1], GenerationConfig(max_new_tokens=6))
    assert single.tokens == tr[1].tokens
    stream = list(t.generate_stream(prompts[0], GenerationConfig(
        max_new_tokens=6), visual_embeds=ves[0]))
    assert stream == tr[0].tokens


@pytest.mark.parametrize("scheduler", ["static", "continuous", "mlfq",
                                       "chunked"])
def test_serve_matches_reference_under_each_scheduler(pair, scheduler):
    j, t = pair
    prompts, ves = _workload(t.cfg, seed=1)

    def reqs(R):
        return [R(rid=i, tokens=list(p), max_new_tokens=5, visual_embeds=v,
                  arrival=0.002 * i)
                for i, (p, v) in enumerate(zip(prompts, ves))]
    kw = dict(max_batch=3, cache_len=64, scheduler=scheduler, chunk_size=8,
              token_budget=24)
    jrep = j.serve(reqs(JRequest), JEngineConfig(**kw), gen=JGen(
        decoder="greedy"))
    trep = t.serve(reqs(Request), EngineConfig(**kw), gen=GenerationConfig(
        decoder="greedy"))
    assert _metrics(trep.requests) == _metrics(jrep.requests)
    assert trep.stats["virtual_time_s"] == jrep.stats["virtual_time_s"]
    assert trep.stats["decode_cost_by_group"] == \
        jrep.stats["decode_cost_by_group"]


def test_kv_accounting_and_abort(pair):
    j, t = pair
    prompts, ves = _workload(t.cfg, seed=2)
    ec = EngineConfig(max_batch=2, cache_len=64)
    eng = t.serve([], ec).engine
    jeng = j.serve([], JEngineConfig(max_batch=2, cache_len=64)).engine
    treqs = [Request(rid=i, tokens=p, max_new_tokens=4, visual_embeds=v)
             for i, (p, v) in enumerate(zip(prompts, ves))]
    jreqs = [JRequest(rid=i, tokens=p, max_new_tokens=4, visual_embeds=v)
             for i, (p, v) in enumerate(zip(prompts, ves))]
    assert [eng.kv_request_tokens(r) for r in treqs] == \
        [jeng.kv_request_tokens(r) for r in jreqs]
    for r in treqs:
        eng.submit(r)
    eng.step()
    assert eng.kv_committed_tokens() == sum(eng.kv_request_tokens(r)
                                            for r in treqs)
    live = next(r for r in treqs if r.state == State.DECODE)
    slot = live._slot
    assert eng.abort(live.rid)
    assert eng.slot_req[slot] is None and live.aborted
    assert not eng.abort(live.rid)
    rest = eng.run()
    assert rest["finished"] == len(treqs) - 1
    assert eng.kv_committed_tokens() == 0
    assert all(s is None for s in eng.slot_req)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 0.0), (0.7, 0, 0.0), (1.0, 5, 0.0), (1.3, 0, 0.8),
    (0.9, 20, 0.5)])
def test_sample_probs_match_reference(temperature, top_k, top_p):
    logits = np.random.default_rng(3).standard_normal((4, 512)
                                                      ).astype(np.float32)
    want = jsampling.sample_probs(jnp.asarray(logits), temperature=temperature,
                                  top_k=top_k, top_p=top_p)
    got = tsampling.sample_probs(torch.from_numpy(logits),
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    tok = tsampling.sample_token(gen, torch.from_numpy(logits),
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p)
    assert bool((got[torch.arange(4), tok.long()] > 0).all())


def test_sampling_decoder_runs(pair):
    _, t = pair
    prompts, _ = _workload(t.cfg)
    gen = GenerationConfig(max_new_tokens=4, decoder="sampling",
                           temperature=0.8, top_k=50, seed=7)
    a = t.generate(prompts[:2], gen)
    b = t.generate(prompts[:2], gen)
    assert [r.tokens for r in a] == [r.tokens for r in b]   # seeded
    assert all(0 <= x < t.cfg.vocab_size for r in a for x in r.tokens)


def test_later_slices_raise(pair):
    """What stays refused, as the reference refuses it: a per-request KV
    preset on an engine not built compacting, speculative or early exit
    on a compacting engine, and a request past the cache. Speculative and
    early exit serve otherwise (tests/test_torch_decoder_engine.py); a
    KV handoff request is served too, reserving its prompt plus one
    token (tests/test_torch_disaggregation.py)."""
    _, t = pair
    assert GenerationConfig(decoder="speculative").gamma == 4
    assert GenerationConfig(decoder="early_exit").exit_threshold == 0.9
    eng = t.serve([], EngineConfig(max_batch=1, cache_len=32)).engine
    with pytest.raises(ValueError, match="not built compacting"):
        eng.submit(Request(rid=0, tokens=[1, 2], compression="streaming-kv"))
    handoff = Request(rid=1, tokens=[1, 2], max_new_tokens=4, handoff=True)
    eng.submit(handoff)
    assert eng.kv_request_tokens(handoff) == eng._kv_block()
    assert eng.abort(1)
    eng.submit(Request(rid=2, tokens=[1, 2], max_new_tokens=4,
                       decoder="early_exit"))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=3, tokens=[1] * 30, max_new_tokens=8))
    comp = t.serve([], EngineConfig(max_batch=2, cache_len=32),
                   gen=GenerationConfig(compression="streaming-kv")).engine
    for dec in ("speculative", "early_exit"):
        with pytest.raises(ValueError, match="compaction"):
            comp.submit(Request(rid=4, tokens=[1, 2], max_new_tokens=4,
                                decoder=dec))
        with pytest.raises(ValueError, match="compaction"):
            t.generate([1, 2, 3], GenerationConfig(
                decoder=dec, max_new_tokens=2, compression="streaming-kv"))
