"""The port's visual-token compression against the JAX reference.

The same numpy inputs go through each reference compressor and its port:
kept indices must be identical and compressed embeddings agree within
1e-5 (float32). Duplicate-heavy inputs (repeated tokens, a static video)
pin the top-k tie rule (``jax.lax.top_k`` keeps the lower index first).
The engine on the qwen2-vl smoke config serves a mixed-compression batch
with tokens, virtual-clock metrics and compression stats equal to the
reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import EngineConfig as JEngineConfig
from repro.api import GenerationConfig as JGen
from repro.api import Request as JRequest
from repro.api import generation as jgeneration
from repro.core.token_compression import merging as jmerging
from repro.core.token_compression import policy as jpolicy
from repro.core.token_compression import pruning as jpruning
from repro.core.token_compression import video as jvideo
from repro.training.checkpoint import _flatten
from repro_torch.api import (COMPRESSION_PRESETS, LVLM, CompressionConfig,
                             EngineConfig, GenerationConfig, Request,
                             make_compressor, resolve_compression)
from repro_torch.api import video as tvideo_api
from repro_torch.core.serving.engine import Engine
from repro_torch.core.token_compression import merging as tmerging
from repro_torch.core.token_compression import policy as tpolicy
from repro_torch.core.token_compression import pruning as tpruning
from repro_torch.core.token_compression import video as tvideo
from repro_torch.models.convert import params_from_flat

ATOL = 1e-5
B, N, D = 2, 64, 32


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _same_idx(got, want):
    np.testing.assert_array_equal(_np(got).astype(np.int64),
                                  _np(want).astype(np.int64))


def _tokens(kind, seed=0, b=B, n=N, d=D):
    """[B, N, d] float32: random, or duplicate-heavy.

    The duplicates are 1 or 2 times one of 8 basis vectors. Every norm,
    cosine and product of such tokens is exact in float32 whatever the
    summation order, so equal scores are bit-equal ties in both libraries
    and the kept set is decided by the tie rule alone. (Repeats of random
    rows would not do: their similarities come out of a matrix product
    whose rounding differs between libraries and between rows, so the
    "ties" would be broken by rounding noise, not by the rule.)"""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((b, n, d)).astype(np.float32)
    x = np.zeros((b, n, d), np.float32)
    bi, ni = np.meshgrid(np.arange(b), np.arange(n), indexing="ij")
    x[bi, ni, rng.integers(0, 8, (b, n))] = rng.integers(1, 3, (b, n))
    return x


def _video(kind, seed=0, b=B, f=8, p=16, d=D):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((b, f, p, d)).astype(np.float32)
    frame = rng.standard_normal((b, 1, p, d)).astype(np.float32)
    return np.repeat(frame, f, axis=1)                  # static: all tie


def _query(seed=1, b=B, q=5, d=D, kind="random"):
    """[B, Q, d] text-token embeddings; with duplicates, basis vectors
    like the tokens', so the relevance scores stay exact too."""
    if kind == "random":
        return np.random.default_rng(seed).standard_normal((b, q, d)
                                                           ).astype(np.float32)
    return _tokens("duplicates", seed=seed, b=b, n=q, d=d)


# ------------------------------------------------------------- pruners --

@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("name,kw", [
    ("fastv", {"scores": "scores"}),
    ("sparsevlm", {"query": "query"}),
    ("l2", {}),
    ("l2", {"key": "key"}),
    ("divprune", {}),
    ("cdpruner", {}),
    ("cdpruner", {"query": "query"}),
])
@pytest.mark.parametrize("keep", [1, 21, 32])
def test_pruner_matches_reference(kind, name, kw, keep):
    x = _tokens(kind)
    if (name, kind) == ("cdpruner", "random") and "query" not in kw:
        # without a query the DPP kernel's diagonal is
        # s_ii = (|x| / (|x| + 1e-6))^2, the same float for every
        # unit-scale token, so the first pick would be a rounding tie
        # that neither library defines; norms spread over two decades
        # below 1e-5 separate the diagonal
        x = x * (10.0 ** np.random.default_rng(9).uniform(
            -7.5, -5.5, (B, N, 1))).astype(np.float32)
    rng = np.random.default_rng(7)
    extra = {"scores": -np.linalg.norm(x, axis=-1).round(1),  # many ties
             "query": _query(kind=kind),
             "key": rng.standard_normal((B, N, 16)).astype(np.float32)}
    args = {k: extra[v] for k, v in kw.items()}
    jo, ji, jinfo = jpruning.PRUNERS[name](
        jnp.asarray(x), keep, **{k: jnp.asarray(v) for k, v in args.items()})
    to, ti, tinfo = tpruning.PRUNERS[name](
        torch.from_numpy(x), keep,
        **{k: torch.from_numpy(v) for k, v in args.items()})
    _same_idx(ti, ji)
    assert bool((ti[:, 1:] > ti[:, :-1]).all())         # sorted, distinct
    _same(to, jo)
    assert tinfo == jinfo


def test_sparsevlm_promotes_a_bf16_query():
    """A bf16 query against float32 visual tokens (the full-width engine's
    case) promotes like jnp.einsum instead of raising."""
    x, q = _tokens("random"), _query()
    qb = torch.from_numpy(q).to(torch.bfloat16)
    jq = jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16)
    for name in ("sparsevlm", "cdpruner"):
        _, ji, _ = jpruning.PRUNERS[name](jnp.asarray(x), 20, query=jq)
        _, ti, _ = tpruning.PRUNERS[name](torch.from_numpy(x), 20, query=qb)
        _same_idx(ti, ji)


def test_topk_tie_order_is_jax_order():
    s = [1.0, 3, 3, 0, 3, 3, 1, 3]
    got = tpruning.topk_indices(torch.tensor(s), 5)
    _same_idx(got, [1, 2, 4, 5, 7])


@pytest.mark.parametrize("n,layers,stages,ratio", [
    (1024, 28, 4, 0.125), (576, 32, 3, 0.25), (16, 2, 4, 0.5)])
def test_pyramiddrop_schedule_matches_reference(n, layers, stages, ratio):
    assert tpruning.pyramiddrop_schedule(n, layers, stages, ratio) == \
        jpruning.pyramiddrop_schedule(n, layers, stages, ratio)


# ------------------------------------------------------------- mergers --

@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("r", [1, 12, 32])
def test_tome_merge_matches_reference(kind, r):
    x = _tokens(kind, seed=2)
    sizes = np.random.default_rng(3).integers(1, 4, (B, N)).astype(np.float32)
    for s in (None, sizes):
        jo, js, jinfo = jmerging.tome_merge(
            jnp.asarray(x), r, sizes=None if s is None else jnp.asarray(s))
        to, ts, tinfo = tmerging.tome_merge(
            torch.from_numpy(x), r,
            sizes=None if s is None else torch.from_numpy(s))
        _same(to, jo)
        _same(ts, js)
        assert tinfo == jinfo


@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("keep", [1, 7, 32, 50])
def test_tome_to_count_matches_reference(kind, keep):
    x = _tokens(kind, seed=4)
    jo, js = jmerging.tome_to_count(jnp.asarray(x), keep)
    to, ts = tmerging.tome_to_count(torch.from_numpy(x), keep)
    assert to.shape == jo.shape
    _same(to, jo)
    _same(ts, js)


@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("with_scores", [False, True])
@pytest.mark.parametrize("keep", [1, 16, 40])
def test_prune_then_merge_matches_reference(kind, with_scores, keep):
    x = _tokens(kind, seed=5)
    scores = np.linalg.norm(x, axis=-1).round(1) if with_scores else None
    jo, ji, jinfo = jmerging.prune_then_merge(
        jnp.asarray(x), keep,
        scores=None if scores is None else jnp.asarray(scores))
    to, ti, tinfo = tmerging.prune_then_merge(
        torch.from_numpy(x), keep,
        scores=None if scores is None else torch.from_numpy(scores))
    _same_idx(ti, ji)
    _same(to, jo)
    assert tinfo == jinfo


# --------------------------------------------------------------- video --

@pytest.mark.parametrize("kind", ["random", "static"])
@pytest.mark.parametrize("fn,args", [
    ("frame_similarity", ()),
    ("dycoke_ratio", ()),
    ("temporal_merge", (1,)),
    ("temporal_merge", (3,)),
    ("temporal_merge", (8,)),
    ("llama_vid_compress", ()),
    ("llama_vid_compress", ("query",)),
    ("dynamic_compress", (40,)),
    ("dynamic_compress", (128,)),
    ("framefusion", (1,)),
    ("framefusion", (30,)),
])
def test_video_matches_reference(kind, fn, args):
    v = _video(kind, seed=6)
    q = _query(seed=8)
    jargs = [jnp.asarray(q) if a == "query" else a for a in args]
    targs = [torch.from_numpy(q) if a == "query" else a for a in args]
    want = getattr(jvideo, fn)(jnp.asarray(v), *jargs)
    got = getattr(tvideo, fn)(torch.from_numpy(v), *targs)
    if isinstance(want, tuple):
        (want, winfo), (got, ginfo) = want, got
        assert set(ginfo) == set(winfo)
        for k in winfo:
            _same(ginfo[k], winfo[k])
    assert tuple(got.shape) == tuple(want.shape)
    _same(got, want)


def test_dynamic_compress_static_video_keeps_the_first_frames():
    """A static video ties on every frame: the budget is filled from the
    lowest flat indices, as lax.top_k orders ties."""
    v = _video("static", seed=9, b=1, f=8, p=16)
    out, _ = tvideo.dynamic_compress(torch.from_numpy(v), 40)
    flat = v.reshape(1, 128, D)
    sal = np.linalg.norm(v - v.mean(2, keepdims=True), axis=-1)[0, 0]
    order = np.argsort(-sal, kind="stable")
    picks = sorted(f * 16 + int(p) for f in range(8) for p in order[:5])
    _same(out, flat[:, picks])


def test_api_video_exports_the_five_functions():
    for name in ("frame_similarity", "temporal_merge", "llama_vid_compress",
                 "dycoke_ratio", "dynamic_compress", "framefusion"):
        assert getattr(tvideo_api, name) is getattr(tvideo, name)


# -------------------------------------------------------------- policy --

ALL_PRESETS = ("none", "fastv-0.5", "sparsevlm-0.5", "l2-0.5",
               "divprune-0.5", "cdpruner-0.5", "tome-0.5",
               "framefusion-0.25", "tome-0.3", "l2-0.75")


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_compress_visual_tokens_matches_reference(preset):
    x = _tokens("random", seed=10)
    q = _query(seed=11)
    jcc, tcc = jgeneration.resolve_compression(preset), \
        resolve_compression(preset)
    jo, ji, jinfo = jpolicy.compress_visual_tokens(jcc, jnp.asarray(x),
                                                   query=jnp.asarray(q))
    to, ti, tinfo = tpolicy.compress_visual_tokens(tcc, torch.from_numpy(x),
                                                   query=torch.from_numpy(q))
    assert (ti is None) == (ji is None)
    if ti is not None:
        _same_idx(ti, ji)
    _same(to, jo)
    assert tinfo == jinfo


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_compressed_token_count_is_the_output_length(preset):
    """Shape-only and exact for n in 1..200 (tome's capped rounds and
    round-half-to-even included), and equal to the reference's count."""
    cc = resolve_compression(preset)
    strat = make_compressor(preset)
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((1, 3, 8)).astype(np.float32))
    for n in range(1, 201):
        x = torch.from_numpy(rng.standard_normal((1, n, 8)
                                                 ).astype(np.float32))
        out, _, _ = tpolicy.compress_visual_tokens(cc, x, query=q)
        count = tpolicy.compressed_token_count(cc, n)
        assert out.shape[1] == count == strat.compressed_token_count(n), n
        assert count == jpolicy.compressed_token_count(
            jgeneration.resolve_compression(preset), n), n


def test_fastv_scores_from_attention_matches_reference():
    p = np.random.default_rng(13).random((2, 3, 5, 40)).astype(np.float32)
    _same(tpolicy.fastv_scores_from_attention(torch.from_numpy(p), (4, 20)),
          jpolicy.fastv_scores_from_attention(jnp.asarray(p), (4, 20)))


RESOLVABLE = tuple(jgeneration.COMPRESSION_PRESETS) + (
    "fastv-0.25", "tome-0.75", "sparsevlm-0.3", "l2-1", "cdpruner-1.0",
    "framefusion-0.1", "streaming-kv-128", "l2-kv-256")


@pytest.mark.parametrize("spec", RESOLVABLE)
def test_resolve_compression_matches_reference(spec):
    want = dataclasses.asdict(jgeneration.resolve_compression(spec))
    got = dataclasses.asdict(resolve_compression(spec))
    assert got == want
    assert tpolicy._derive_name(resolve_compression(spec)) == \
        jpolicy._derive_name(jgeneration.resolve_compression(spec))
    jstrat = jpolicy.CompressionStrategy(jgeneration.resolve_compression(spec))
    tstrat = tpolicy.CompressionStrategy(resolve_compression(spec))
    for attr in ("name", "encoder_active", "needs_query", "kv_selector"):
        assert getattr(tstrat, attr) == getattr(jstrat, attr), attr
    assert tstrat.decode_budget() == jstrat.decode_budget()


def test_presets_match_reference_field_for_field():
    assert list(COMPRESSION_PRESETS) == list(jgeneration.COMPRESSION_PRESETS)
    for name, cc in COMPRESSION_PRESETS.items():
        assert dataclasses.asdict(cc) == \
            dataclasses.asdict(jgeneration.COMPRESSION_PRESETS[name]), name
    assert dataclasses.asdict(CompressionConfig()) == \
        dataclasses.asdict(jgeneration.CompressionConfig())


@pytest.mark.parametrize("spec", [
    "quantum-entangle-0.5", "fastv", "fastv-0", "fastv-1.5", "tome-x",
    "streaming-kv-0", "snapkv-kv-64", "pyramiddrop-0.5"])
def test_unknown_compression_names_raise_as_the_reference(spec):
    with pytest.raises(ValueError) as jerr:
        jgeneration.resolve_compression(spec)
    with pytest.raises(ValueError) as terr:
        resolve_compression(spec)
    assert str(terr.value) == str(jerr.value)


def test_make_compressor_names_and_pass_through():
    assert make_compressor("fastv-0.5").name == "fastv-0.5"
    assert make_compressor(None).name == "none"
    cc = CompressionConfig(token_merger="tome", keep_ratio=0.25)
    assert make_compressor(cc).name == "tome-0.25"
    strat = make_compressor("divprune-0.5")
    assert make_compressor(strat) is strat

    class Custom:
        def compress_prefill(self, embeds, **_):
            return embeds, None, {}
    custom = Custom()
    assert make_compressor(custom) is custom
    with pytest.raises(TypeError):
        make_compressor(3)


# -------------------------------------------------------------- engine --

MIX = ("none", "fastv-0.5", "sparsevlm-0.5", "l2-0.5", "divprune-0.5",
       "cdpruner-0.5", "tome-0.5", "framefusion-0.25")


@pytest.fixture(scope="module")
def pair():
    j = JLVLM.from_pretrained("qwen2-vl-2b", smoke=True)
    t = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, device="cpu")
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    return j, t.with_params(params_from_flat(flat, "cpu"))


def _mixed(cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 12, 7, 14, 10, 8, 11, 6)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) for _ in MIX]
    return prompts, ves


def _reqs(R, prompts, ves):
    return [R(rid=i, tokens=list(p), max_new_tokens=4, visual_embeds=v,
              arrival=0.002 * i, compression=c)
            for i, (p, v, c) in enumerate(zip(prompts, ves, MIX))]


def _metrics(reqs):
    return {r.rid: (list(r.generated), r.ttft(), r.tpot(), r.jct())
            for r in reqs}


@pytest.mark.parametrize("scheduler", ["continuous", "chunked"])
def test_mixed_compression_serve_matches_reference(pair, scheduler):
    j, t = pair
    prompts, ves = _mixed(t.cfg)
    kw = dict(max_batch=4, cache_len=48, scheduler=scheduler, chunk_size=8,
              token_budget=24)
    jrep = j.serve(_reqs(JRequest, prompts, ves), JEngineConfig(**kw),
                   gen=JGen(decoder="greedy"))
    trep = t.serve(_reqs(Request, prompts, ves), EngineConfig(**kw),
                   gen=GenerationConfig(decoder="greedy"))
    assert len(trep.requests) == len(MIX)
    assert _metrics(trep.requests) == _metrics(jrep.requests)
    assert trep.engine.compression_stats() == jrep.engine.compression_stats()
    assert set(trep.stats) == set(jrep.stats)
    for k, v in jrep.stats.items():
        if k.startswith("compression/") or k in ("virtual_time_s",
                                                 "iterations", "ttft_mean"):
            assert trep.stats[k] == v, k
    jeng, teng = jrep.engine, trep.engine
    for tr, jr in zip(_reqs(Request, prompts, ves),
                      _reqs(JRequest, prompts, ves)):
        assert teng.kv_request_tokens(tr) == jeng.kv_request_tokens(jr)
    assert list(teng.slot_nv) == list(jeng.slot_nv)


def test_kv_reservation_shrinks_with_keep_ratio(pair):
    _, t = pair
    eng = t.serve([], EngineConfig(max_batch=2, cache_len=256)).engine
    ve = np.random.default_rng(0).standard_normal(
        (t.cfg.num_visual_tokens, t.cfg.d_model)).astype(np.float32)

    def reserved(compression):
        return eng.kv_request_tokens(Request(
            rid=99, tokens=list(range(1, 13)), max_new_tokens=8,
            visual_embeds=ve, compression=compression))
    # text 12 + nv 16 + new 8 = 36 -> 48; fastv-0.5: 28 -> 32;
    # framefusion-0.25: 24 -> 32 (16-token blocks)
    assert [reserved(c) for c in (None, "fastv-0.5", "framefusion-0.25")] \
        == [48, 32, 32]
    r = Request(rid=0, tokens=list(range(1, 13)), max_new_tokens=8,
                visual_embeds=ve, compression="fastv-0.5")
    eng.submit(r)
    assert eng.kv_committed_tokens() == 32


@pytest.mark.parametrize("preset", ["sparsevlm-0.5", "cdpruner-0.5"])
def test_cross_modal_pruner_receives_prompt_query(pair, preset):
    """The engine hands the prompt's embeddings to sparsevlm / cdpruner:
    tokens equal an uncompressed run over the visual tokens compressed
    WITH that query, and equal the reference's."""
    j, t = pair
    rng = np.random.default_rng(14)
    prompt = rng.integers(1, t.cfg.vocab_size, 9).tolist()
    ve = (rng.standard_normal((t.cfg.num_visual_tokens, t.cfg.d_model))
          * 0.02).astype(np.float32)
    gen = GenerationConfig(decoder="greedy", max_new_tokens=4,
                           compression=preset)
    out = t.generate(prompt, gen, visual_embeds=ve)
    jout = j.generate(prompt, JGen(decoder="greedy", max_new_tokens=4,
                                   compression=preset), visual_embeds=ve)
    assert out.tokens == jout.tokens
    query = t.params["embed"]["tok"][torch.tensor([prompt])]
    cc = resolve_compression(preset)
    ve_q, idx_q, _ = tpolicy.compress_visual_tokens(
        cc, torch.from_numpy(ve)[None], query=query)
    _, idx_0, _ = tpolicy.compress_visual_tokens(
        cc, torch.from_numpy(ve)[None], query=torch.zeros_like(query))
    assert not torch.equal(idx_q, idx_0)     # the query conditions the pick
    ref = t.generate(prompt, GenerationConfig(decoder="greedy",
                                              max_new_tokens=4),
                     visual_embeds=ve_q[0].numpy())
    assert out.tokens == ref.tokens


def test_generation_config_compression_is_the_named_default(pair):
    j, t = pair
    prompts, ves = _mixed(t.cfg, seed=3)
    gen = GenerationConfig(decoder="greedy", max_new_tokens=4,
                           compression="fastv-0.5")
    res = t.generate(prompts[:2], gen, visual_embeds=ves[:2])
    jres = j.generate(prompts[:2], JGen(decoder="greedy", max_new_tokens=4,
                                        compression="fastv-0.5"),
                      visual_embeds=ves[:2])
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert _metrics([r.request for r in res]) == \
        _metrics([r.request for r in jres])
    stream = list(t.generate_stream(prompts[0], gen, visual_embeds=ves[0]))
    assert stream == res[0].tokens
    rep = t.serve([], EngineConfig(max_batch=1, cache_len=64), gen=gen)
    assert rep.engine._default_comp_name == "fastv-0.5"
    cfg_default = t.serve([], EngineConfig(max_batch=1, cache_len=64),
                          gen=GenerationConfig(compression=CompressionConfig(
                              token_pruner="l2", keep_ratio=0.5)))
    assert cfg_default.engine._default_comp_name == "l2-0.5"
    # the default reaches the engine only through Engine(compressor=)
    assert "compression" not in {
        f.name for f in dataclasses.fields(EngineConfig)}
    assert t.serve([], EngineConfig(max_batch=1, cache_len=64)
                   ).engine._default_comp_name == "none"


def test_custom_strategy_via_compressors(pair):
    _, t = pair

    class KeepHalf:
        name = "keep-half"
        encoder_active = True

        def __init__(self):
            self.queries = []

        def compress_prefill(self, embeds, *, query=None, scores=None):
            self.queries.append(query)
            return embeds[:, :embeds.shape[1] // 2], None, {}

        def compressed_token_count(self, n):
            return n // 2

    rng = np.random.default_rng(4)
    ve = (rng.standard_normal((t.cfg.num_visual_tokens, t.cfg.d_model))
          * 0.02).astype(np.float32)
    tokens = rng.integers(1, 512, 8).tolist()
    strat = KeepHalf()
    r = Request(rid=0, tokens=list(tokens), max_new_tokens=2,
                visual_embeds=ve, compression="keep-half")
    rep = t.serve([r], EngineConfig(max_batch=1, cache_len=64),
                  compressors={"keep-half": strat})
    assert rep.engine.slot_nv[0] == t.cfg.num_visual_tokens // 2
    assert rep.engine.kv_request_tokens(r) == 32       # 8 + 8 + 2 -> 32
    assert len(r.generated) == 2
    # custom strategies are handed the prompt's query by default
    assert tuple(strat.queries[0].shape) == (1, 8, t.cfg.d_model)
    # a strategy object as the facade's default
    res = t.generate(tokens, GenerationConfig(max_new_tokens=2,
                                              compression=KeepHalf()),
                     visual_embeds=ve)
    assert res.tokens == r.generated


@pytest.mark.parametrize("spec", ["streaming-kv", "l2-kv",
                                  "streaming-kv-128"])
def test_kv_presets_are_refused(pair, spec):
    """Live KV compaction waits for the compacting engine (ROADMAP A9):
    the presets resolve, but serving them raises, per request and as the
    engine default."""
    _, t = pair
    assert resolve_compression(spec).kv_budget > 0
    with pytest.raises(NotImplementedError, match="A9"):
        GenerationConfig(compression=spec)
    eng = t.serve([], EngineConfig(max_batch=1, cache_len=64)).engine
    with pytest.raises(NotImplementedError, match="A9"):
        eng.submit(Request(rid=0, tokens=[1, 2, 3], max_new_tokens=2,
                           compression=spec))
    with pytest.raises(NotImplementedError, match="A9"):
        Engine(t.model, t.params, EngineConfig(max_batch=1, cache_len=64),
               compressor=make_compressor(spec))


def test_unknown_request_compression_is_rejected(pair):
    _, t = pair
    eng = t.serve([], EngineConfig(max_batch=1, cache_len=64)).engine
    with pytest.raises(ValueError, match="unknown compression"):
        eng.submit(Request(rid=0, tokens=[1, 2, 3], max_new_tokens=2,
                           compression="quantum-entangle-0.5"))
