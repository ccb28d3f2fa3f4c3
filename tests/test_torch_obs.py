"""The port's observability (``repro_torch.obs`` and the engine's hooks)
against the JAX reference (``repro.obs``), float32 smoke configs on the CPU.

Same weights through the bridge, same requests through both packages:

  * zero overhead when off: the port's default engine and server hold
    ``NULL_TRACER`` / ``NULL_PROFILER`` and make no hook call (every null
    method patched to raise; sync and async serves must not trip one);
  * tracing and profiling change nothing: traced, profiled runs give the
    untraced run's tokens at temperature 0;
  * the trace IS the reference's: every event's kind, name, rid, replica,
    slot, virtual time, duration, value and attributes are equal (only
    the wall clock ``wt`` differs), for a mixed-decoder chunked serve, a
    compressed VLM serve and an async serve under admission pressure; a
    port trace passes the reference's ``validate_trace``;
  * the profiler sees the reference's sites with the reference's counts
    and virtual times; ``metrics_snapshot()`` is the reference's text once
    the wall-time families are removed (both with the port's own sites,
    ``PORT_SITES``, left out: the reference has none of them);
  * the port's own sites form a well-formed tree (every site closed, each
    inside its parent, the model's under ``engine.step``, one attention and
    one FFN site a layer a call) whose shapes are the engine's and
    ``apply_moe``'s; the profiler's epoch clock holds ``torch.profiler``'s
    events of a site inside the site, and the sites export to a
    Chrome-trace track of their own;
  * the unit contracts of ``tests/test_obs.py`` and ``tests/test_profile.py``
    (span pairing, Chrome-trace shape, validation, JSONL sink, stats
    helper, profiler attribution and buckets, Prometheus histograms),
    without their migration, router, regression-gate and report cases.
"""
import asyncio
import json
import time

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.obs import Profiler as JProfiler
from repro.obs import Tracer as JTracer
from repro.obs import to_chrome_trace as j_to_chrome_trace
from repro.obs import validate_trace as j_validate_trace
from repro.training.checkpoint import _flatten
import repro_torch.api as tapi
from repro_torch.analysis.sanitizer import SanitizerError
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from repro_torch.models.registry import build
from repro_torch.models.convert import params_from_flat
from repro_torch.obs import (NULL_PROFILER, NULL_TRACER, JsonlSink,
                             NullProfiler, NullTracer, Profiler, Tracer,
                             load_trace, mean_or_none, percentile_summary,
                             profile_families, summarize_records,
                             to_chrome_trace, validate_trace,
                             write_chrome_trace)
from repro_torch.obs.perfetto import SITES_PID
from repro_torch.obs.profile import bucket_bounds
from repro_torch.obs.prom import PromText
from repro_torch.serving import MetricsRegistry

MAX_NEW = 6
MIXED = ["speculative", "greedy", "early_exit", "sampling"]


def _bridge(j, arch):
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    t = tapi.LVLM.from_pretrained(arch, smoke=True, device="cpu")
    return t.with_params(params_from_flat(flat, "cpu"))


@pytest.fixture(scope="module")
def phi():
    j = japi.LVLM.from_pretrained("phi4-mini-3.8b", smoke=True)
    return j, _bridge(j, "phi4-mini-3.8b")


@pytest.fixture(scope="module")
def vlm():
    j = japi.LVLM.from_pretrained("qwen2-vl-2b", smoke=True)
    return j, _bridge(j, "qwen2-vl-2b")


@pytest.fixture(scope="module")
def moe():
    """deepseek-v3's smoke model (a dense layer, then an expert layer):
    the port alone, for its ``model.moe`` site."""
    model = build(get_config("deepseek-v3-671b", smoke=True))
    return model, model.init(0, "cpu")


def _moe_calls(model, params, s=24):
    """A capacity-1.25 prefill of ``s`` tokens, then one decode step."""
    _, cache = model.prefill(params, {"tokens": torch.arange(s)[None] + 1},
                             cache_len=s + 8, last_only=True)
    model.decode_step(params, cache, torch.ones(1, 1, dtype=torch.long),
                      torch.tensor([s]))


def _gen(api, **kw):
    base = dict(decoder="greedy", temperature=0.0, max_new_tokens=MAX_NEW,
                gamma=3)
    base.update(kw)
    return api.GenerationConfig(**base)


def _ec(api, **kw):
    base = dict(max_batch=4, cache_len=96, temperature=0.0, sanitize=True)
    base.update(kw)
    return api.EngineConfig(**base)


def _prompts(n, seed=0, lo=8, hi=16):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 512, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _reqs(api, prompts, new=MAX_NEW, decoders=None):
    reqs = [api.Request(rid=i, tokens=list(p), max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r, d in zip(reqs, decoders or ()):
        r.decoder = d
    return reqs


async def _consume(stream):
    return [tok async for tok in stream]


def _drive_all(server, reqs):
    async def drive():
        async with server:
            return await asyncio.gather(
                *(_consume(server.submit(r)) for r in reqs))

    outs = asyncio.run(drive())
    return {r.rid: list(o) for r, o in zip(reqs, outs)}


def _tokens(reqs):
    return {r.rid: list(r.generated) for r in reqs}


def _no_wall(events):
    """Tracer events without their wall clock (the one field that may
    differ between the packages)."""
    return [{k: v for k, v in ev.items() if k != "wt"} for ev in events]


# the port's own profiler sites, which the reference does not have
PORT_SITES = ("engine.step", "model.prefill", "model.extend", "model.decode",
              "model.attn", "model.ffn", "model.moe", "model.head",
              "engine.sample", "server.fan_out")


def _virtual_sites(prof):
    """Per-site count, virtual time and virtual histogram (wall excluded)
    of the reference's sites."""
    return {site: (s["count"], s["virtual_s"], s["virtual_buckets"])
            for site, s in prof.snapshot().items() if site not in PORT_SITES}


def _no_wall_families(text):
    """A Prometheus snapshot without its wall-time families and the port's
    own sites."""
    return [line for line in text.splitlines()
            if "profile_wall_" not in line
            and not any(f'site="{n}"' in line for n in PORT_SITES)]


# ------------------------------------------------- zero overhead when off --

def test_untraced_unprofiled_hot_path_makes_no_hook_calls(phi, vlm, moe,
                                                          monkeypatch):
    """With tracing and profiling off, no hook runs: every NullTracer and
    NullProfiler method is patched to raise, and a sync serve (mixed
    decoders, chunked prefill), a compressed VLM serve and an async serve
    all finish."""
    def boom(*a, **k):
        raise AssertionError("hook called on the untraced/unprofiled path")

    for name in ("span_begin", "span_end", "span_abort", "instant",
                 "slice", "counter"):
        monkeypatch.setattr(NullTracer, name, boom)
    for name in ("site_begin", "site_end", "close_laps"):
        monkeypatch.setattr(NullProfiler, name, boom)
    _moe_calls(*moe)                  # the expert layer's site, unprofiled
    t = phi[1]
    res = t.serve(_reqs(tapi, _prompts(4, seed=1), decoders=MIXED),
                  _ec(tapi, scheduler="chunked", chunk_size=4), gen=_gen(tapi))
    assert res.engine.tracer is NULL_TRACER
    assert res.engine.profiler is NULL_PROFILER
    assert res.stats["finished"] == 4
    res = vlm[1].serve(_vlm_reqs(tapi, vlm[1].cfg), _ec(tapi), gen=_gen(tapi))
    assert res.stats["finished"] == 3
    got = _drive_all(t.serve_async(_ec(tapi), gen=_gen(tapi)),
                     _reqs(tapi, _prompts(2, seed=2)))
    assert all(len(o) == MAX_NEW for o in got.values())


def test_traced_profiled_run_is_bit_identical_at_temp0(phi):
    t = phi[1]
    prompts = _prompts(4, seed=3)
    ec = _ec(tapi, scheduler="chunked", chunk_size=8)
    ref = t.serve(_reqs(tapi, prompts, decoders=MIXED), ec, gen=_gen(tapi))
    got = t.serve(_reqs(tapi, prompts, decoders=MIXED), ec, gen=_gen(tapi),
                  obs=True, profile=True)
    assert _tokens(got.requests) == _tokens(ref.requests)
    assert got.engine.tracer.events and got.engine.profiler.snapshot()
    assert {"engine.step", "model.extend", "model.attn", "model.head",
            "engine.sample"} <= set(got.engine.profiler.snapshot())
    a = _drive_all(t.serve_async(_ec(tapi), gen=_gen(tapi)),
                   _reqs(tapi, prompts, decoders=MIXED))
    b = _drive_all(t.serve_async(_ec(tapi), gen=_gen(tapi), obs=True,
                                 profile=True),
                   _reqs(tapi, prompts, decoders=MIXED))
    assert a == b


# ----------------------------------------------- parity with the reference --

def _vlm_reqs(api, cfg):
    """Three VLM requests: no compression, a fastv pruner and a tome
    merger on the visual tokens."""
    rng = np.random.RandomState(21)
    reqs = []
    for i, comp in enumerate((None, "fastv-0.5", "tome-0.5")):
        r = api.Request(rid=i, tokens=list(rng.randint(1, 512, size=10)),
                        max_new_tokens=4, visual_embeds=rng.randn(
                            cfg.num_visual_tokens, cfg.d_model
                        ).astype(np.float32))
        r.compression = comp
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("case", ["mixed_chunked", "vlm_compressed"])
def test_sync_trace_and_profile_equal_reference(phi, vlm, case):
    """``serve(obs=True, profile=True)``: the port's events equal the
    reference's (wall clock aside), its profiler sites equal the
    reference's in count and virtual time, and the trace validates with
    both packages' ``validate_trace``."""
    def run(api, lvlm):
        if case == "mixed_chunked":
            reqs = _reqs(api, _prompts(4, seed=4, lo=12, hi=30),
                         decoders=MIXED)
            ec = _ec(api, scheduler="chunked", chunk_size=8,
                     token_budget=24)
        else:
            reqs, ec = _vlm_reqs(api, lvlm.cfg), _ec(api)
        res = lvlm.serve(reqs, ec, gen=_gen(api), obs=True, profile=True)
        return res.engine.tracer, res.engine.profiler, _tokens(reqs)

    j_tr, j_prof, j_tok = run(japi, (phi if case == "mixed_chunked"
                                     else vlm)[0])
    t_tr, t_prof, t_tok = run(tapi, (phi if case == "mixed_chunked"
                                     else vlm)[1])
    assert t_tok == j_tok
    assert _no_wall(t_tr.events) == _no_wall(j_tr.events)
    assert _virtual_sites(t_prof) == _virtual_sites(j_prof)
    sites = set(t_prof.snapshot())
    assert "prefill_forward" in sites
    assert (sites >= {"decode:speculative", "decode:greedy",
                      "decode:early_exit", "decode:sampling"}
            if case == "mixed_chunked" else "compress" in sites)
    assert t_tr.open_spans() == []
    assert j_validate_trace(j_to_chrome_trace(t_tr.events)) == []
    assert validate_trace(to_chrome_trace(t_tr.events)) == []


def test_async_trace_snapshot_and_summary_equal_reference(phi):
    """``serve_async(obs=True, profile=True)`` under admission pressure:
    admission-wait spans, pump counters and engine events equal the
    reference's, and so do ``metrics_snapshot()`` (wall-time families
    removed) and ``summary()``."""
    prompts = _prompts(5, seed=5, lo=12, hi=15)

    def run(api, lvlm):
        adm = api.AdmissionConfig(high_watermark=0.25, low_watermark=0.15)
        server = lvlm.serve_async(_ec(api, cache_len=64), gen=_gen(api),
                                  admission=adm, obs=True, profile=True)
        got = _drive_all(server, _reqs(api, prompts,
                                       decoders=MIXED + ["greedy"]))
        return (got, server.tracer, server.metrics_snapshot(),
                server.summary(), server.profiler)

    j = run(japi, phi[0])
    t = run(tapi, phi[1])
    assert t[0] == j[0]
    assert _no_wall(t[1].events) == _no_wall(j[1].events)
    names = {e["name"] for e in t[1].events}
    assert {"admission_wait", "kv_committed_tokens",
            "admission_queue_depth", "first_token"} <= names
    assert _no_wall_families(t[2]) == _no_wall_families(j[2])
    assert "# TYPE repro_profile_wall_seconds histogram" in t[2]
    assert t[3] == j[3]
    assert _virtual_sites(t[4]) == _virtual_sites(j[4])
    assert j_validate_trace(j_to_chrome_trace(t[1].events)) == []


def test_untraced_metrics_snapshot_equals_reference(phi):
    def run(api, lvlm):
        server = lvlm.serve_async(_ec(api), gen=_gen(api))
        got = _drive_all(server, _reqs(api, _prompts(3, seed=10)))
        return got, server.metrics_snapshot()

    (j_got, j_text), (t_got, text) = run(japi, phi[0]), run(tapi, phi[1])
    assert t_got == j_got and text == j_text
    assert "repro_requests_finished_total 3.0" in text
    assert 'repro_ttft_seconds{quantile="0.5"}' in text
    assert "repro_kv_committed_tokens 0.0" in text
    assert "repro_admitted_total 3.0" in text
    assert text.count("# TYPE repro_requests_finished_total") == 1
    assert "profile_wall_seconds" not in text


def test_abort_mid_chunked_prefill_closes_trace(phi):
    """An abort between prefill chunks closes the request and prefill
    spans with the abort marker, as the reference's do, and the
    sanitizer stays clean at every pump iteration."""
    prompt = list(np.random.RandomState(5).randint(1, 512, size=40))

    def run(api, lvlm, tracer):
        server = lvlm.serve_async(
            _ec(api, cache_len=128, scheduler="chunked", chunk_size=8),
            gen=_gen(api), obs=tracer)
        eng = server.engine
        real_step, n = eng.step, [0]

        def step_then_abort():
            progressed = real_step()
            n[0] += 1
            if n[0] == 2:
                server.abort(0)
            return progressed

        eng.step = step_then_abort

        async def drive():
            async with server:
                s = server.submit(api.Request(rid=0, tokens=prompt,
                                              max_new_tokens=MAX_NEW))
                return await _consume(s), s.aborted
        return asyncio.run(drive())

    jt, tt = JTracer(), Tracer()
    assert run(japi, phi[0], jt) == run(tapi, phi[1], tt) == ([], True)
    assert "prefill" in {e["name"] for e in tt.events if e["k"] == "B"}
    assert tt.open_spans() == []
    ends = {e["name"] for e in tt.events if e["k"] == "E"
            and (e.get("attrs") or {}).get("aborted")}
    assert ends >= {"request", "prefill"}
    assert _no_wall(tt.events) == _no_wall(jt.events)
    assert validate_trace(to_chrome_trace(tt.events)) == []


def test_disconnect_timeout_closes_trace(phi):
    tracer = Tracer()
    server = phi[1].serve_async(_ec(tapi), gen=_gen(tapi),
                                disconnect_timeout_s=0.05, obs=tracer)
    eng = server.engine
    real_step = eng.step

    def paced_step():
        import time
        time.sleep(0.02)
        return real_step()

    eng.step = paced_step
    p0, p1 = _prompts(2, seed=7, lo=10, hi=12)

    async def drive():
        async with server:
            s0 = server.submit(tapi.Request(rid=0, tokens=p0,
                                            max_new_tokens=24))
            t1 = asyncio.create_task(_consume(server.submit(
                tapi.Request(rid=1, tokens=p1, max_new_tokens=24))))
            got = []
            async for tok in s0:
                got.append(tok)
                if len(got) == 2:
                    await asyncio.sleep(0.5)     # consumer goes silent
            return got, await t1, s0

    got, out1, s0 = asyncio.run(drive())
    assert s0.disconnected and len(out1) == 24
    assert server.disconnects == 1
    assert tracer.open_spans() == []
    end = next(e for e in tracer.events if e["k"] == "E"
               and e["name"] == "request" and e["rid"] == 0)
    assert (end.get("attrs") or {}).get("aborted")
    assert validate_trace(to_chrome_trace(tracer.events)) == []


# -------------------------------------------- sanitizer <-> tracer cross --

def test_sanitizer_flags_missing_span_for_live_request(phi):
    tracer = Tracer()
    eng = phi[1]._serve_engine(_ec(tapi), _gen(tapi), tracer=tracer)
    eng.submit(tapi.Request(rid=0, tokens=_prompts(1, seed=8)[0],
                            max_new_tokens=MAX_NEW))
    tracer.span_end("request", 0, replica=0, vt=eng.clock)
    with pytest.raises(SanitizerError, match="no open trace span"):
        eng.step()


def test_sanitizer_flags_orphan_span(phi):
    tracer = Tracer()
    eng = phi[1]._serve_engine(_ec(tapi), _gen(tapi), tracer=tracer)
    eng.submit(tapi.Request(rid=0, tokens=_prompts(1, seed=9)[0],
                            max_new_tokens=MAX_NEW))
    tracer.span_begin("request", 99, replica=0, vt=eng.clock)
    with pytest.raises(SanitizerError, match="orphan span"):
        eng.step()


# ----------------------------------------------------------- tracer units --

def test_span_abort_closes_all_open_spans_innermost_first():
    t = Tracer()
    t.span_begin("request", 1, replica=0, vt=0.0)
    t.span_begin("prefill", 1, replica=0, vt=0.1)
    t.span_begin("request", 2, replica=0, vt=0.1)
    t.span_abort(1, replica=0, vt=0.2, reason="test")
    assert t.open_spans() == [(2, "request")]
    ends = [e for e in t.events if e["k"] == "E"]
    assert [e["name"] for e in ends] == ["prefill", "request"]
    assert all(e["attrs"]["aborted"] and e["attrs"]["reason"] == "test"
               for e in ends)
    assert t.open_requests(0) == {2}


def test_double_begin_auto_aborts_stale_span():
    t = Tracer()
    t.span_begin("request", 1, replica=0, vt=0.0)
    t.span_begin("request", 1, replica=1, vt=0.5)
    assert t.open_spans() == [(1, "request")]
    assert t.open_requests(1) == {1}
    assert validate_trace(to_chrome_trace(t.events + [
        t._event("E", "request", rid=1, replica=1, vt=0.6)])) == []


def _tiny_trace(cls=Tracer):
    t = cls()
    t.span_begin("request", 1, replica=0, vt=0.0, prompt_len=8)
    t.instant("first_token", 1, replica=0, vt=0.001)
    t.slice("engine_step", 0.0, 0.002, replica=0)
    t.slice("decode_step", 0.0, 0.002, replica=0, slot=3, rid=1)
    t.counter("kv_committed_tokens", 12, replica=0, vt=0.002)
    t.span_end("request", 1, replica=0, vt=0.002, tokens=4)
    return t


def test_chrome_trace_shape_equals_reference():
    doc = to_chrome_trace(_tiny_trace().events)
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {m["name"] for m in meta} >= {"process_name", "thread_name"}
    b = next(e for e in evs if e["ph"] == "b")
    e_ = next(e for e in evs if e["ph"] == "e")
    assert b["cat"] == e_["cat"] == "request"
    assert b["id"] == e_["id"] == 1
    assert b["ts"] == 0.0 and e_["ts"] == pytest.approx(2000.0)
    assert b["args"]["prompt_len"] == 8 and "wall_s" in b["args"]
    lanes = {e["name"]: e["tid"] for e in evs if e["ph"] == "X"}
    assert lanes["engine_step"] == 0 and lanes["decode_step"] == 4
    c = next(e for e in evs if e["ph"] == "C")
    assert c["args"]["value"] == 12
    assert next(e for e in evs if e["ph"] == "i")["s"] == "t"
    json.loads(json.dumps(doc))
    # the reference's exporter on the same events gives the same document
    events = _tiny_trace().events
    assert to_chrome_trace(events) == j_to_chrome_trace(events)


def test_write_and_load_chrome_trace(tmp_path):
    p = str(tmp_path / "trace.json")
    write_chrome_trace(_tiny_trace().events, p)
    assert validate_trace(load_trace(p)) == []


def test_validate_catches_orphans_unbalanced_and_rewinds():
    t = _tiny_trace()
    orphan = [e for e in t.events
              if not (e["k"] == "E" and e["name"] == "request")]
    probs = validate_trace(to_chrome_trace(orphan))
    assert any("orphan" in p for p in probs)
    assert probs == j_validate_trace(j_to_chrome_trace(orphan))
    rewind = [
        {"k": "B", "name": "request", "rid": 1, "rep": 0, "vt": 1.0,
         "wt": 0.0},
        {"k": "E", "name": "request", "rid": 1, "rep": 0, "vt": 0.5,
         "wt": 1.0},
    ]
    probs = validate_trace(to_chrome_trace(rewind))
    assert any("clock went backwards" in p for p in probs)
    probs = validate_trace({"traceEvents": []})
    assert any("no request spans" in p for p in probs)
    probs = validate_trace(to_chrome_trace(t.events),
                           require_migrations=True)
    assert any("migration" in p for p in probs)


def test_validate_cli(tmp_path):
    from repro_torch.obs import validate as vmod
    good = str(tmp_path / "good.json")
    write_chrome_trace(_tiny_trace().events, good)
    assert vmod.main([good]) == 0
    bad = str(tmp_path / "bad.json")
    with open(bad, "w", encoding="utf-8") as f:
        json.dump(to_chrome_trace(_tiny_trace().events[:-1]), f)
    assert vmod.main([bad]) != 0


def test_jsonl_sink_streams_and_loads(tmp_path):
    p = str(tmp_path / "events.jsonl")
    t = Tracer()
    sink = JsonlSink(p)
    t.add_sink(sink)
    t.span_begin("request", 1, replica=0, vt=0.0)
    t.span_end("request", 1, replica=0, vt=0.1)
    sink.close()
    lines = [json.loads(line) for line in open(p, encoding="utf-8")]
    assert lines == t.events
    assert validate_trace(load_trace(p)) == []
    q = str(tmp_path / "dump.jsonl")
    assert t.write_jsonl(q) == 2
    assert validate_trace(load_trace(q)) == []


def test_stats_helper_handles_empty_and_matches_registry():
    assert mean_or_none([]) is None
    assert mean_or_none([1.0, 3.0]) == 2.0
    s = percentile_summary([], "ttft")
    assert s["ttft_p50"] is None and s["ttft_p95"] is None
    out = summarize_records([])
    assert out["finished"] == 0 and out["ttft_p50"] is None
    reg = MetricsRegistry()
    req = tapi.Request(rid=0, tokens=[1, 2, 3], max_new_tokens=2)
    req.first_token_time, req.finish_time = 0.01, 0.02
    req.generated = [5, 6]
    rec = reg.observe(req, queue_wait=0.002, decoder="greedy")
    assert rec.tokens == 2
    assert reg.summary() == summarize_records(reg.records)


# --------------------------------------------------------- profiler units --

def _manual_profiler(cls=Profiler):
    t = [0.0]
    return cls(clock=lambda: t[0]), t


def test_profiler_self_total_nesting_equals_reference():
    def run(cls):
        prof, t = _manual_profiler(cls)
        prof.site_begin("outer")
        t[0] = 1.0
        prof.site_begin("inner")
        t[0] = 3.0
        prof.site_end("inner", vt=0.5)
        t[0] = 4.0
        prof.site_end("outer", vt=1.5)
        return prof

    prof, ref = run(Profiler), run(JProfiler)
    snap = prof.snapshot()
    assert snap["outer"]["wall_total_s"] == pytest.approx(4.0)
    assert snap["outer"]["wall_self_s"] == pytest.approx(2.0)
    assert snap["inner"]["wall_self_s"] == pytest.approx(2.0)
    assert snap["outer"]["virtual_s"] == pytest.approx(1.5)
    assert snap == ref.snapshot()


def test_profiler_log_buckets_and_mismatched_end():
    bounds = bucket_bounds()
    assert all(b2 == 2 * b1 for b1, b2 in zip(bounds, bounds[1:]))
    prof, t = _manual_profiler()
    for dur in (1e-6, 3e-6, 3e-6, 0.5):
        t0 = t[0]
        prof.site_begin("s")
        t[0] = t0 + dur
        prof.site_end("s")
    buckets = {round(le, 9): n
               for le, n in prof.snapshot()["s"]["wall_buckets"] if n}
    assert buckets[round(1e-6, 9)] == 1 and buckets[round(4e-6, 9)] == 2
    assert sum(buckets.values()) == 4
    prof, t = _manual_profiler()
    prof.site_end("never_opened")
    prof.site_begin("outer")
    prof.site_begin("leaked")
    t[0] = 1.0
    prof.site_end("outer")
    snap = prof.snapshot()
    assert "leaked" not in snap and snap["outer"]["count"] == 1


def test_profiler_intervals_nest_and_carry_attrs():
    """Every closed site is an interval in begin order with its parent's
    index and its attributes, on the epoch clock of the anchor pair; a
    leaked site is left out (its children move to its parent), and past
    ``max_intervals`` only the histograms go on."""
    prof, t = _manual_profiler()
    prof.anchor_epoch_ns, prof.anchor_clock = 10**18, 0.0
    prof.site_begin("engine.step")
    t[0] = 1.0
    prof.site_begin("model.decode")
    prof.site_begin("leaked")
    prof.site_begin("model.attn")
    t[0] = 1.5
    prof.site_end("model.attn")
    t[0] = 2.0
    prof.site_end("model.decode", rows_live=3, rows_launched=4)
    prof.site_begin("engine.sample")
    t[0] = 2.25
    prof.site_end("engine.sample", rid=7)
    t[0] = 3.0
    prof.site_end("engine.step")
    got = [(s["name"], s["t0_ns"] - 10**18, s["t1_ns"] - 10**18,
            s["parent"], s["attrs"]) for s in prof.intervals()]
    assert got == [
        ("engine.step", 0, 3 * 10**9, -1, {}),
        ("model.decode", 10**9, 2 * 10**9, 0,
         {"rows_live": 3, "rows_launched": 4}),
        ("model.attn", 10**9, 15 * 10**8, 1, {}),
        ("engine.sample", 2 * 10**9, 225 * 10**7, 0, {"rid": 7})]
    assert prof.epoch_ns(2.0) == 10**18 + 2 * 10**9
    assert prof.snapshot()["model.attn"]["count"] == 1
    # laps: regions timed by the caller, filed inside the open site
    prof.site_begin("model.decode")
    prof.laps += [("model.attn", 3.0, 3.5, None),
                  ("model.moe", 3.5, 4.0, {"pairs": 8})]
    prof.close_laps()
    t[0] = 5.0
    prof.site_end("model.decode")
    got = [(s["name"], s["t0_ns"] - 10**18, s["parent"], s["attrs"])
           for s in prof.intervals()[4:]]
    assert got == [("model.decode", 3 * 10**9, -1, {}),
                   ("model.attn", 3 * 10**9, 4, {}),
                   ("model.moe", 35 * 10**8, 4, {"pairs": 8})]
    assert prof.laps == []
    snap = prof.snapshot()
    assert snap["model.attn"]["count"] == 2
    assert snap["model.decode"]["wall_self_s"] == pytest.approx(1.0 + 1.0)
    capped = Profiler()
    capped.max_intervals = 2
    for _ in range(3):
        capped.site_begin("s")
        capped.site_end("s")
    assert len(capped.intervals()) == 2 and capped.intervals_dropped == 1
    assert capped.snapshot()["s"]["count"] == 3
    assert NULL_PROFILER.intervals() == []


def test_profiler_epoch_clock_holds_torch_profiler_events():
    """Host work inside a site: ``torch.profiler``'s CPU events (epoch ns)
    lie inside the site's exported interval, within 50 us."""
    from torch.profiler import ProfilerActivity, profile
    prof = Profiler()
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        prof.site_begin("model.attn")
        for _ in range(3):
            a = torch.tanh(a @ a)
        prof.site_end("model.attn")
    site = prof.intervals()[0]
    evs = [e for e in tp.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert evs
    for e in evs:
        assert site["t0_ns"] - 50_000 <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= site["t1_ns"] + 50_000


def test_chrome_trace_draws_sites_on_a_wall_clock_track(tmp_path):
    prof, t = _manual_profiler()
    prof.anchor_epoch_ns, prof.anchor_clock = 1_700_000_000 * 10**9, 0.0
    prof.site_begin("engine.step")
    t[0] = 0.002
    prof.site_end("engine.step", decode_batch=3)
    tiny = _tiny_trace().events
    doc = to_chrome_trace(tiny, sites=prof.intervals())
    ev = [e for e in doc["traceEvents"] if e["pid"] == SITES_PID]
    assert [e["ph"] for e in ev] == ["M", "X"]
    assert ev[0]["args"]["name"] == "host sites (wall clock)"
    assert ev[1]["ts"] == pytest.approx(1.7e15)
    assert ev[1]["dur"] == pytest.approx(2000.0)
    assert ev[1]["args"] == {"decode_batch": 3}
    assert validate_trace(doc) == []
    p = str(tmp_path / "trace.json")
    assert write_chrome_trace(tiny, p, sites=prof.intervals()) == \
        len(doc["traceEvents"])
    assert validate_trace(load_trace(p)) == []
    assert to_chrome_trace(tiny) == j_to_chrome_trace(tiny)


def test_prom_histogram_rendering():
    prom = PromText()
    prom.histogram("lat_seconds", "Latency.", [(0.001, 2), (0.004, 1)],
                   0.0055, 4, labels={"site": "s"})
    prom.histogram("lat_seconds", "Latency.", [(0.001, 1)], 0.001, 1,
                   labels={"site": "t"})
    text = prom.render()
    assert text.count("# TYPE repro_lat_seconds histogram") == 1
    assert 'repro_lat_seconds_bucket{le="0.001",site="s"} 2' in text
    assert 'repro_lat_seconds_bucket{le="0.004",site="s"} 3' in text
    assert 'repro_lat_seconds_bucket{le="+Inf",site="s"} 4' in text
    assert 'repro_lat_seconds_sum{site="s"} 0.0055' in text
    assert 'repro_lat_seconds_count{site="s"} 4' in text
    assert 'repro_lat_seconds_bucket{le="+Inf",site="t"} 1' in text


def test_profile_families_and_server_snapshot(phi):
    prof, t = _manual_profiler()
    prof.site_begin("a")
    t[0] = 0.002
    prof.site_end("a", vt=0.25)
    prom = PromText()
    profile_families(prom, prof, labels={"cluster": "x"})
    text = prom.render()
    assert "# TYPE repro_profile_virtual_seconds histogram" in text
    assert 'repro_profile_virtual_seconds_sum{cluster="x",site="a"} 0.25' \
        in text
    server = phi[1].serve_async(_ec(tapi), _gen(tapi), profile=Profiler())
    _drive_all(server, _reqs(tapi, _prompts(2, seed=6)))
    solo = server.metrics_snapshot()
    assert "# TYPE repro_profile_wall_seconds histogram" in solo
    assert 'site="prefill_forward"' in solo and 'site="decode:greedy"' in solo
    assert "repro_profile_wall_self_seconds_total" in solo
    assert "profile_wall_seconds" not in server.metrics_snapshot(replica=0)


# ------------------------------------------------- the port's own sites --

def _children(iv, i, name):
    return [s for s in iv if s["parent"] == i and s["name"] == name]


def _ancestors(iv, i):
    out, p = [], iv[i]["parent"]
    while p >= 0:
        out.append(iv[p]["name"])
        p = iv[p]["parent"]
    return out


def _check_tree(prof, n_layers, max_batch):
    """Every site closed, each inside its parent, every model call under
    ``engine.step`` with one attention and one FFN site a layer and one
    head, and a decode's rows those of its step's decode batch."""
    iv = prof.intervals()
    assert prof._stack == [] and len(iv) == len(prof._spans)
    assert prof.intervals_dropped == 0
    for s in iv:
        assert s["t0_ns"] <= s["t1_ns"]
        if s["parent"] >= 0:
            p = iv[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"]
    calls = [i for i, s in enumerate(iv) if s["name"] in
             ("model.prefill", "model.extend", "model.decode")]
    assert calls
    for i in calls:
        assert "engine.step" in _ancestors(iv, i)
        assert len(_children(iv, i, "model.attn")) == n_layers
        assert len(_children(iv, i, "model.ffn")) == n_layers
        assert len(_children(iv, i, "model.head")) == 1
        a = iv[i]["attrs"]
        if iv[i]["name"] == "model.decode":
            step = iv[i]
            while step["name"] != "engine.step":
                step = iv[step["parent"]]
            assert a["rows_live"] == step["attrs"]["decode_batch"]
            assert a["rows_launched"] == max_batch
        else:
            assert a["q"] > 0 and a["ctx"] >= a["q"] and "rid" in a
    return iv


def test_site_tree_is_well_formed(phi, vlm):
    """Recorded serves of the smoke models: an async greedy serve (decode
    rows), a chunked one (extends at each chunk's offset) and a VLM one
    (visual tokens in the prefill's shape)."""
    layers = phi[1].cfg.num_layers
    prof = Profiler()
    server = phi[1].serve_async(_ec(tapi), gen=_gen(tapi), obs=True,
                                profile=prof)
    _drive_all(server, _reqs(tapi, _prompts(3, seed=8)))
    iv = _check_tree(prof, layers, 4)
    names = {s["name"] for s in iv}
    assert {"server.fan_out", "engine.sample", "model.decode"} <= names
    assert any(s["attrs"].get("rows_live", 0) > 1 for s in iv)

    prompts = _prompts(2, seed=9, lo=20, hi=24)
    res = phi[1].serve(_reqs(tapi, prompts),
                       _ec(tapi, scheduler="chunked", chunk_size=8),
                       gen=_gen(tapi), profile=True)
    iv = _check_tree(res.engine.profiler, layers, 4)
    for rid, p in enumerate(prompts):
        ext = [s["attrs"] for s in iv if s["name"] == "model.extend"
               and s["attrs"]["rid"] == rid]
        first = next(s["attrs"] for s in iv if s["name"] == "model.prefill"
                     and s["attrs"]["rid"] == rid)
        assert first == {"rid": rid, "q": 8, "ctx": 8, "nv": 0}
        assert [(a["q"], a["ctx"]) for a in ext] == \
            [(min(8, len(p) - c), min(c + 8, len(p)))
             for c in range(8, len(p), 8)]

    reqs = _vlm_reqs(tapi, vlm[1].cfg)[:1]
    res = vlm[1].serve(reqs, _ec(tapi), gen=_gen(tapi), profile=True)
    iv = _check_tree(res.engine.profiler, vlm[1].cfg.num_layers, 4)
    nv = vlm[1].cfg.num_visual_tokens
    assert next(s["attrs"] for s in iv if s["name"] == "model.prefill") \
        == {"rid": 0, "q": 10 + nv, "ctx": 10 + nv, "nv": nv}


def test_moe_sites_carry_apply_moe_shapes(moe, monkeypatch):
    """In the expert layer ``model.moe`` takes ``model.ffn``'s place, and
    its ``pairs`` / ``buffer_rows`` are the (token, choice) pairs and the
    E * (C + 1) buffer rows of ``apply_moe``'s own dispatch, for a
    capacity-1.25 prefill and a dropless decode."""
    model, params = moe
    seen = []
    real = MOE._dispatch

    def spy(xg, idx, gates, cap, e):
        seen.append((idx.numel(), e * idx.shape[0] * (cap + 1)))
        return real(xg, idx, gates, cap, e)

    monkeypatch.setattr(MOE, "_dispatch", spy)
    prof = Profiler()
    monkeypatch.setattr(model, "profiler", prof)
    _moe_calls(model, params, s=24)
    iv = prof.intervals()
    sites = [s for s in iv if s["name"] == "model.moe"]
    assert [(s["attrs"]["pairs"], s["attrs"]["buffer_rows"])
            for s in sites] == seen
    k, e = model.cfg.experts_per_token, model.cfg.num_experts
    cap = max(1, int(1.25 * 24 * k / e))
    assert seen == [(24 * k, e * (cap + 1)), (k, e * (k + 1))]
    assert [s["name"] for s in iv] == 2 * [
        "model.attn", "model.ffn", "model.attn", "model.moe", "model.head"]

