"""The dense-family and MoE configs of the port against the reference.

granite-34b (MQA, 8 / 1 heads at smoke size), mistral-large-123b,
nemotron-4-340b (layernorm, squared ReLU) and arctic-480b (128 experts
top-2 at full size, 4 at smoke, with Arctic's dense residual) at smoke
size, and arctic with a dense prefix layer and a shared expert. The
reference's params reach the port through the flattened bridge; the same
numpy tokens go through both on the CPU in float32.

* Model entry points: ``forward`` / ``prefill`` / ``extend`` (scalar and
  [B] starts) / ``decode_step`` logits within 1e-4 of the logit scale,
  the MoE capacity defaults included (1.25 for prefill and extend: tokens
  drop; dropless decode).
* Serving: greedy tokens identical and virtual TTFT / TPOT / JCT exactly
  equal under all four schedulers; early exit and speculative decoding
  (self-draft) on arctic smoke too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import EngineConfig as JEngineConfig
from repro.api import GenerationConfig as JGen
from repro.api import Request as JRequest
from repro.training.checkpoint import _flatten
from repro_torch.api import LVLM, EngineConfig, GenerationConfig, Request
from repro_torch.models.convert import params_from_flat

TOL = 1e-4
ARCHS = {
    "granite": ("granite-34b", {}),
    "mistral": ("mistral-large-123b", {}),
    "nemotron": ("nemotron-4-340b", {}),
    "arctic": ("arctic-480b", {}),
    "arctic_dense_prefix": ("arctic-480b", dict(first_k_dense_layers=1,
                                                num_shared_experts=1)),
}
SCHEDULERS = ("static", "continuous", "mlfq", "chunked")
_PAIRS = {}


def _pair(name):
    """(reference LVLM, port LVLM with the same weights), built once."""
    if name not in _PAIRS:
        arch, kw = ARCHS[name]
        j = JLVLM.from_pretrained(arch, smoke=True, **kw)
        t = LVLM.from_pretrained(arch, smoke=True, device="cpu", **kw)
        flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
        _PAIRS[name] = (j, t.with_params(params_from_flat(flat, "cpu")))
    return _PAIRS[name]


def _close(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= TOL * scale, np.abs(j - t).max() / scale


def _metrics(reqs):
    return {r.rid: (list(r.generated), r.ttft(), r.tpot(), r.jct())
            for r in reqs}


@pytest.mark.parametrize("name", list(ARCHS))
def test_model_entry_points_match_reference(name):
    j, t = _pair(name)
    jm, jp, tm, tp = j.model, j.params, t.model, t.params
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 19)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    jf, jaux = jm.forward(jp, {"tokens": jt})
    tf, taux = tm.forward(tp, {"tokens": tt})
    _close(jf, tf)
    assert jaux.keys() == taux.keys()
    if cfg.num_experts:
        assert abs(float(jaux["lb_loss"]) - float(taux["lb_loss"])) <= 1e-5
    jl, jc = jm.prefill(jp, {"tokens": jt}, cache_len=64)
    tl, tc = tm.prefill(tp, {"tokens": tt}, cache_len=64)
    _close(jl, tl)
    assert jc.keys() == tc.keys()
    for key in jc:
        _close(jc[key]["k"], tc[key]["k"])

    pos = np.array([19, 16], np.int32)            # ragged decode positions
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
    td, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                            torch.from_numpy(pos))
    _close(jd, td)
    ext = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    je, jc = jm.extend(jp, jc, jnp.asarray(ext), jnp.int32(20))
    te, tc = tm.extend(tp, tc, torch.from_numpy(ext).long(), 20)
    _close(je, te)
    starts = np.array([26, 22], np.int32)         # per-row [B] starts
    je, jc = jm.extend(jp, jc, jnp.asarray(ext), jnp.asarray(starts))
    te, tc = tm.extend(tp, tc, torch.from_numpy(ext).long(),
                       torch.from_numpy(starts))
    _close(je, te)
    for key in jc:
        _close(jc[key]["v"], tc[key]["v"])


@pytest.mark.parametrize("name", ["arctic", "arctic_dense_prefix"])
def test_moe_dropless_forward_matches_reference(name):
    """``moe_cap=None`` (the decode setting) through a whole prompt."""
    j, t = _pair(name)
    toks = np.random.default_rng(3).integers(0, 512, (3, 13)
                                             ).astype(np.int32)
    jf, _ = j.model.forward(j.params, {"tokens": jnp.asarray(toks)},
                            moe_cap=None)
    tf, _ = t.model.forward(t.params, {"tokens": torch.from_numpy(
        toks).long()}, moe_cap=None)
    _close(jf, tf)


def _requests(R, cfg, seed, lens=(9, 30, 5)):
    rng = np.random.default_rng(seed)
    return [R(rid=i, tokens=rng.integers(0, cfg.vocab_size, n).tolist(),
              max_new_tokens=4, arrival=0.002 * i)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("name", ["granite", "mistral", "nemotron",
                                  "arctic"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_serve_matches_reference_under_each_scheduler(name, scheduler):
    j, t = _pair(name)
    kw = dict(max_batch=2, cache_len=64, scheduler=scheduler, chunk_size=8,
              token_budget=24)
    jrep = j.serve(_requests(JRequest, t.cfg, 1), JEngineConfig(**kw),
                   gen=JGen(decoder="greedy"))
    trep = t.serve(_requests(Request, t.cfg, 1), EngineConfig(**kw),
                   gen=GenerationConfig(decoder="greedy"))
    assert _metrics(trep.requests) == _metrics(jrep.requests)
    assert trep.stats["virtual_time_s"] == jrep.stats["virtual_time_s"]


def test_generate_dense_prefix_matches_reference():
    j, t = _pair("arctic_dense_prefix")
    prompts = [r.tokens for r in _requests(Request, t.cfg, 2)]
    jr = j.generate(prompts, JGen(max_new_tokens=6, decoder="greedy"))
    tr = t.generate(prompts, GenerationConfig(max_new_tokens=6,
                                              decoder="greedy"))
    assert _metrics([r.request for r in tr]) == \
        _metrics([r.request for r in jr])


@pytest.mark.parametrize("decoder", ["speculative", "early_exit",
                                     "early_exit_fires"])
def test_arctic_decoders_match_reference(decoder):
    """Self-draft speculative decoding (gamma 3) and early exit, never
    firing and firing at layer 1, on arctic smoke: tokens, clock and the
    decoder's stats."""
    j, t = _pair("arctic")
    prompts = [r.tokens for r in _requests(Request, t.cfg, 4, (9, 14))]
    kw = dict(temperature=0.0, max_new_tokens=5)
    if decoder == "speculative":
        kw.update(decoder="speculative", gamma=3)
    else:
        fires = decoder == "early_exit_fires"
        kw.update(decoder="early_exit", exit_threshold=0.0 if fires else 1.1,
                  exit_patience=0 if fires else 2,
                  exit_min_layers=1 if fires else 2)
    jr = j.generate(prompts, JGen(**kw))
    tr = t.generate(prompts, GenerationConfig(**kw))
    assert _metrics([r.request for r in tr]) == \
        _metrics([r.request for r in jr])
    for key, val in jr[0].stats.items():
        if isinstance(val, (int, float, str, list)):
            assert tr[0].stats[key] == val, key
    if decoder == "early_exit_fires":
        assert set(tr[0].stats["layers_used"]) == {1}


def test_early_exit_refuses_a_dense_prefix_moe():
    from repro_torch.core.decoding.early_exit import early_exit_decode_step
    _, t = _pair("arctic_dense_prefix")
    cache = t.model.init_cache(1, 16)
    with pytest.raises(NotImplementedError, match="dense-prefix"):
        early_exit_decode_step(t.model, t.params, cache,
                               torch.zeros((1, 1), dtype=torch.long), 0)


def _shared_prefix_requests(R, cfg, seed=6):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, 16).tolist()
    return [R(rid=i, tokens=head + rng.integers(0, cfg.vocab_size, n).tolist(),
              max_new_tokens=4, arrival=0.002 * i)
            for i, n in enumerate((6, 14, 3))]


@pytest.mark.parametrize("engine", ["compacting", "prefix_cache",
                                    "small_draft"])
def test_engines_take_the_moe_family(engine):
    """The compacting engine (streaming-kv-16 over 48-row slots), the
    prefix cache and speculative decoding with a small draft serve arctic
    with a dense prefix layer and a shared expert (the ``dense_layers``
    cache stack beside ``layers``) as the reference does."""
    import jax
    from repro.models.registry import build as jbuild
    j, t = _pair("arctic_dense_prefix")
    kw = dict(max_batch=2, cache_len=48, scheduler="continuous")
    gkw = dict(decoder="greedy")
    jdraft = tdraft = None
    if engine == "compacting":
        gkw["compression"] = "streaming-kv-16"
    elif engine == "prefix_cache":
        kw.update(prefix_cache=True, prefix_block=8)
    else:
        small = dict(num_layers=1, d_model=128, num_heads=4, num_kv_heads=2,
                     head_dim=32, d_ff=256, num_experts=0,
                     first_k_dense_layers=0, num_shared_experts=0,
                     family="dense")
        jm = jbuild(j.cfg.with_(**small))
        jp = jm.init(jax.random.PRNGKey(1))
        jdraft = JLVLM(jm, jp)
        tdraft = LVLM.from_config(t.cfg.with_(**small), device="cpu"
                                  ).with_params(params_from_flat(
                                      {k: np.asarray(v) for k, v in
                                       _flatten(jp).items()}, "cpu"))
        gkw.update(decoder="speculative", gamma=3, temperature=0.0)
    jrep = j.serve(_shared_prefix_requests(JRequest, t.cfg),
                   JEngineConfig(**kw), gen=JGen(**gkw), draft=jdraft)
    trep = t.serve(_shared_prefix_requests(Request, t.cfg),
                   EngineConfig(**kw), gen=GenerationConfig(**gkw),
                   draft=tdraft)
    assert _metrics(trep.requests) == _metrics(jrep.requests)
    assert trep.stats["virtual_time_s"] == jrep.stats["virtual_time_s"]
    if engine == "compacting":
        assert trep.engine.compacting
    if engine == "prefix_cache":
        assert trep.stats["prefix_hit_tokens"] == \
            jrep.stats["prefix_hit_tokens"] > 0
