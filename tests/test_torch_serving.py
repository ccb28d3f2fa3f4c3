"""The port's async streaming server (``repro_torch.serving``) against the
JAX reference (``repro.serving``), float32 phi4-mini smoke on the CPU.

Same weights through the bridge, same prompts, same scenario run through
both packages: the streams' tokens, every ``RequestRecord`` (TTFT / TPOT /
JCT / queue wait on the virtual clock) and ``summary()`` are EXACTLY
equal, for greedy, batched speculative and a mixed greedy / speculative /
early-exit / sampling batch under all four schedulers. The contracts of
``tests/test_async_serving.py`` are held on the port: async equals sync at
temperature 0, mid-stream cancel frees the slot, the draft row and the
gamma lookahead, admission defers instead of raising, prefix pins, wall
pacing, disconnect timeouts, FIFO / SLO-slack deferred order and a shared
metrics registry; so are the KV-pressure cases of ``tests/test_serving.py``
and speculative serves at gamma 8 and 12 (verifies of 9 and 13 tokens).
"""
import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.api as japi
from repro.serving import MetricsRegistry as JMetricsRegistry
from repro.training.checkpoint import _flatten
import repro_torch.api as tapi
from repro_torch.core.serving.engine import Engine
from repro_torch.models.convert import params_from_flat
from repro_torch.serving import MetricsRegistry

MAX_NEW = 6
SCHEDULERS = ("static", "continuous", "mlfq", "chunked")
REF = SimpleNamespace(api=japi, MetricsRegistry=JMetricsRegistry)
PORT = SimpleNamespace(api=tapi, MetricsRegistry=MetricsRegistry)


def _gen(api, **kw):
    base = dict(decoder="greedy", temperature=0.0, max_new_tokens=MAX_NEW,
                gamma=3)
    base.update(kw)
    return api.GenerationConfig(**base)


@pytest.fixture(scope="module")
def pair():
    """(reference LVLM, port LVLM) with the same phi4-mini smoke weights."""
    j = japi.LVLM.from_pretrained("phi4-mini-3.8b", smoke=True)
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    t = tapi.LVLM.from_pretrained("phi4-mini-3.8b", smoke=True,
                                  device="cpu")
    return j, t.with_params(params_from_flat(flat, "cpu"))


def _both(pair, scenario):
    """Run ``scenario(ns, lvlm)`` on the reference, then on the port."""
    return scenario(REF, pair[0]), scenario(PORT, pair[1])


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


def _ec(api, **kw):
    base = dict(max_batch=4, cache_len=96, temperature=0.0)
    base.update(kw)
    return api.EngineConfig(**base)


async def _consume(stream, cancel_after=None):
    out = []
    async for tok in stream:
        out.append(tok)
        if cancel_after is not None and len(out) >= cancel_after:
            stream.cancel()
            break
    return out


def _serve_on(server, reqs):
    async def drive():
        async with server:
            return await asyncio.gather(
                *(_consume(server.submit(r)) for r in reqs))

    outs = asyncio.run(drive())
    return {r.rid: list(o) for r, o in zip(reqs, outs)}


def _records(server_or_registry):
    reg = getattr(server_or_registry, "metrics", server_or_registry)
    return [dataclasses.asdict(r) for r in reg.records]


def _tokens(reqs):
    return {r.rid: list(r.generated) for r in reqs}


# ------------------------------------------------- golden equivalence --

MIXED = ["speculative", "greedy", "early_exit", "sampling"]


@pytest.mark.parametrize("scheduler,decoders", [
    ("continuous", None),
    ("continuous", ["speculative"] * 3),
    *[(s, MIXED) for s in SCHEDULERS],
], ids=["greedy", "speculative"] + [f"mixed-{s}" for s in SCHEDULERS])
def test_async_stream_matches_sync_and_reference(pair, scheduler, decoders):
    """Each package's streams equal its own sync ``serve`` at temperature
    0, and the port's tokens, records and summary equal the reference's."""
    n = len(decoders) if decoders else 3
    prompts = _prompts(n, seed=3)

    def scenario(ns, lvlm):
        api = ns.api
        ec = _ec(api, scheduler=scheduler, chunk_size=8, token_budget=24)
        sync = lvlm.serve(_reqs(api, prompts, decoders=decoders), ec,
                          gen=_gen(api))
        server = lvlm.serve_async(ec, gen=_gen(api))
        got = _serve_on(server, _reqs(api, prompts, decoders=decoders))
        assert got == _tokens(sync.requests)
        return got, _records(server), server.summary()

    ref, port = _both(pair, scenario)
    assert port == ref


def test_stream_is_incremental_and_summary_complete(pair):
    """Tokens arrive over several pump iterations, the summary carries the
    full SLO telemetry, and both packages stream at the same steps."""
    prompt = _prompts(1, seed=4)[0]

    def scenario(ns, lvlm):
        req = ns.api.Request(rid=0, tokens=list(prompt), max_new_tokens=8)
        server = lvlm.serve_async(_ec(ns.api), gen=_gen(ns.api))

        async def drive():
            steps = []
            async with server:
                async for _ in server.submit(req):
                    steps.append(server.engine.iters)
            return steps
        return asyncio.run(drive()), server.summary()

    (ref_steps, ref_sum), (steps, s) = _both(pair, scenario)
    assert len(steps) == 8 and steps[0] < steps[-1]
    for key in ("ttft_p50", "ttft_p95", "ttft_p99", "tpot_p50",
                "queue_wait_mean", "slo_ttft_attainment", "slo_goodput",
                "decode_cost_by_group", "virtual_time_s"):
        assert key in s, key
    assert s["finished"] == 1 and s["aborted"] == 0
    assert s["decode_cost_by_group"].get("greedy", 0) > 0
    assert (steps, s) == (ref_steps, ref_sum)


# ------------------------------------------------------- cancellation --

def test_abort_frees_slot_draft_pool_and_lookahead(pair):
    """Mid-stream cancel of a speculative request: its slot, draft-pool row
    and gamma lookahead are freed while the other keeps decoding; the
    pool returns to baseline, and both packages agree on every count."""
    p0, p1 = _prompts(2, seed=5, lo=10, hi=12)

    def scenario(ns, lvlm):
        api = ns.api
        r0 = api.Request(rid=0, tokens=p0, max_new_tokens=24,
                         decoder="speculative")
        r1 = api.Request(rid=1, tokens=p1, max_new_tokens=24,
                         decoder="speculative")
        server = lvlm.serve_async(_ec(api), gen=_gen(api))
        eng = server.engine

        async def drive():
            async with server:
                t1 = asyncio.create_task(_consume(server.submit(r1)))
                s0 = server.submit(r0)
                out0 = await _consume(s0, cancel_after=2)
                slot0 = r0._slot
                mid = dict(
                    slot_freed=eng.slot_req[slot0] is None,
                    draft_freed=slot0 not in
                    eng._decoders["speculative"].bound_slots(),
                    committed=eng.kv_committed_tokens(),
                    r1_need=eng.kv_request_tokens(r1),
                    r1_live=len(r1.generated) < 24,
                    stream_aborted=s0.aborted)
                return out0, await t1, mid

        out0, out1, mid = asyncio.run(drive())
        end = (eng.kv_committed_tokens(),
               all(r is None for r in eng.slot_req),
               eng._decoders["speculative"].bound_slots())
        return (out0, out1, mid, end, r0.aborted, r1.aborted,
                _records(server), server.summary())

    ref, port = _both(pair, scenario)
    out0, out1, mid, end, a0, a1, _, s = port
    assert 2 <= len(out0) < 24 and a0
    assert len(out1) == 24 and not a1
    assert mid["slot_freed"] and mid["draft_freed"] and mid["r1_live"]
    assert mid["stream_aborted"]
    assert mid["committed"] == mid["r1_need"]
    assert mid["r1_need"] >= len(p1) + 24 + 3
    assert end == (0, True, set())
    assert s["aborted"] == 1 and s["finished"] == 1
    assert port == ref


def test_abort_waiting_request_and_unknown_rid(pair):
    t = pair[1]
    eng = Engine(t.model, t.params,
                 tapi.EngineConfig(max_batch=1, cache_len=96, sanitize=True))
    r0 = tapi.Request(rid=0, tokens=list(range(1, 10)), max_new_tokens=4)
    eng.submit(r0)
    assert eng.abort(0) is True
    assert eng.abort(0) is False
    assert eng.abort(99) is False
    assert r0.aborted and eng.waiting == [] and eng.aborted == [r0]
    assert eng.kv_committed_tokens() == 0


def test_cancel_before_first_anext_and_duplicate_rid(pair):
    def scenario(ns, lvlm):
        api = ns.api
        server = lvlm.serve_async(_ec(api), gen=_gen(api))

        async def drive():
            async with server:
                live = server.submit(api.Request(rid=1, tokens=[5, 6, 7],
                                                 max_new_tokens=4))
                dead = server.submit(api.Request(rid=0, tokens=[1, 2, 3],
                                                 max_new_tokens=4))
                with pytest.raises(ValueError):
                    server.submit(api.Request(rid=0, tokens=[9],
                                              max_new_tokens=1))
                assert dead.cancel() is True
                return await _consume(dead), await _consume(live)

        out_dead, out_live = asyncio.run(drive())
        return (out_dead, out_live, server.engine.kv_committed_tokens(),
                [r.rid for r in server.engine.finished], server.summary())

    ref, port = _both(pair, scenario)
    assert port[0] == [] and len(port[1]) == 4
    assert port[2] == 0 and 0 not in port[3] and port[4]["aborted"] == 1
    assert port == ref


def test_pump_failure_propagates_instead_of_hanging(pair):
    server = pair[1].serve_async(_ec(tapi), gen=_gen(tapi))
    boom = RuntimeError("injected step failure")

    def bad_step():
        raise boom

    async def drive():
        async with server:
            server.engine.step = bad_step
            stream = server.submit(tapi.Request(rid=0, tokens=[1, 2, 3],
                                                max_new_tokens=4))
            with pytest.raises(RuntimeError, match="injected"):
                await asyncio.wait_for(_consume(stream), timeout=10)

    with pytest.raises(RuntimeError, match="injected"):
        asyncio.run(drive())
    assert server._pump_error is boom


# ---------------------------------------------------------- admission --

def test_admission_defers_instead_of_raising_when_saturated(pair):
    """KV saturation: submits wait at the gate (at most two live requests
    under the high watermark), every request completes, and the deferrals,
    queue waits and records equal the reference's."""
    prompts = _prompts(5, seed=7, lo=12, hi=15)

    def scenario(ns, lvlm):
        api = ns.api
        adm = api.AdmissionConfig(high_watermark=0.25, low_watermark=0.15)
        server = lvlm.serve_async(_ec(api, cache_len=64), gen=_gen(api),
                                  admission=adm)
        eng = server.engine
        peak = [0]

        async def consume(r):
            out = []
            async for tok in server.submit(r):
                peak[0] = max(peak[0], len(eng.waiting) + len(eng.running))
                out.append(tok)
            return out

        async def drive():
            async with server:
                return await asyncio.gather(
                    *(consume(r) for r in _reqs(api, prompts)))

        outs = asyncio.run(drive())
        return (outs, peak[0], server.admission.deferrals,
                server.admission.queue_depth, _records(server),
                server.summary())

    ref, port = _both(pair, scenario)
    outs, peak, deferrals, depth, _, s = port
    assert all(len(o) == MAX_NEW for o in outs)
    assert peak <= 2 and deferrals >= 3 and depth == 0
    assert s["queue_wait_p99"] > 0
    assert port == ref


def test_oversized_deferred_request_raises_without_killing_pump(pair):
    def scenario(ns, lvlm):
        api = ns.api
        ok = api.Request(rid=0, tokens=_prompts(1, seed=15, lo=12, hi=13)[0],
                         max_new_tokens=MAX_NEW)
        big = api.Request(rid=1, tokens=list(range(1, 40)),
                          max_new_tokens=64)
        adm = api.AdmissionConfig(high_watermark=0.2, low_watermark=0.2)
        server = lvlm.serve_async(_ec(api, cache_len=64), gen=_gen(api),
                                  admission=adm)

        async def drive():
            async with server:
                t0 = asyncio.create_task(_consume(server.submit(ok)))
                await asyncio.sleep(0)
                with pytest.raises(ValueError, match="needs"):
                    await _consume(server.submit(big))
                return await t0

        out0 = asyncio.run(drive())
        return (out0, server._pump_error is None,
                server.admission.deferrals,
                server.engine.kv_committed_tokens())

    ref, port = _both(pair, scenario)
    assert len(port[0]) == MAX_NEW and port[1:] == (True, 1, 0)
    assert port == ref


def test_admission_single_oversized_request_still_progresses(pair):
    def scenario(ns, lvlm):
        api = ns.api
        adm = api.AdmissionConfig(high_watermark=0.05, low_watermark=0.05)
        server = lvlm.serve_async(_ec(api), gen=_gen(api), admission=adm)
        return _serve_on(server, _reqs(api, _prompts(1, seed=8, lo=30,
                                                     hi=31), new=8))

    ref, port = _both(pair, scenario)
    assert len(port[0]) == 8 and port == ref


# -------------------------------------------------------- prefix pins --

def test_prefix_pin_blocks_eviction_until_release(pair):
    t = pair[1]
    eng = Engine(t.model, t.params,
                 tapi.EngineConfig(max_batch=1, cache_len=64,
                                   prefix_cache=True, prefix_block=4,
                                   prefix_cap=1, sanitize=True))
    a = list(range(1, 9))
    eng._prefix_insert(a, 0, 8)
    req = tapi.Request(rid=0, tokens=a + [99], max_new_tokens=2)
    eng.submit(req)
    eng.step()                                    # prefill: hits + pins A
    key = ("none", tuple(a))
    assert eng._prefix_pins.get(key, 0) == 1
    eng._prefix_insert(list(range(101, 109)), 0, 8)   # over cap: A pinned
    assert key in eng._prefix
    while eng.step():
        pass                                      # req retires -> unpin
    assert eng._prefix_pins == {}
    eng._prefix_insert(list(range(201, 209)), 0, 8)   # now A can go
    assert key not in eng._prefix


# ----------------------------------------------- pacing & disconnects --

def test_wall_pacing_sleeps_per_step_virtual_durations(pair, monkeypatch):
    recorded = []
    real_sleep = asyncio.sleep

    async def spy_sleep(dt, *a, **kw):
        recorded.append(dt)
        await real_sleep(0)

    monkeypatch.setattr(asyncio, "sleep", spy_sleep)
    outs = {}
    for pacing in ("virtual", "wall"):
        recorded.clear()
        server = pair[1].serve_async(_ec(tapi), gen=_gen(tapi),
                                     pacing=pacing, pacing_scale=3.0)
        outs[pacing] = _serve_on(server, _reqs(tapi, _prompts(2, seed=11)))
        if pacing == "virtual":
            assert all(dt == 0 for dt in recorded)
        else:
            slept = sum(dt for dt in recorded if dt > 0)
            assert slept == pytest.approx(server.engine.clock * 3.0,
                                          rel=1e-6)
    assert outs["wall"] == outs["virtual"]


def test_bad_pacing_and_unported_paths_rejected(pair):
    """Bad knobs are refused; ``control=`` and the migration methods are
    served (tests/test_torch_control.py, test_torch_disaggregation.py),
    and on a bare server they refuse an unknown rid or a bad ticket
    without registering anything, as the reference's do."""
    t = pair[1]
    with pytest.raises(ValueError, match="pacing"):
        t.serve_async(_ec(tapi), gen=_gen(tapi), pacing="warp")
    with pytest.raises(TypeError, match="control="):
        t.serve_async(_ec(tapi), gen=_gen(tapi), control="aggressive")
    with pytest.raises(TypeError, match="control="):
        t.serve(_reqs(tapi, _prompts(1)), _ec(tapi), gen=_gen(tapi),
                control="aggressive")
    assert isinstance(t.serve_async(_ec(tapi), gen=_gen(tapi),
                                    control=True).control, tapi.Controller)
    server = t.serve_async(_ec(tapi), gen=_gen(tapi))
    assert server.request_migration(0) is False
    with pytest.raises(KeyError):
        server.complete_export(0)
    server.cancel_export(0)                   # no ticket: nothing to undo
    server.release_migrated(0)
    with pytest.raises(KeyError):
        asyncio.run(server.import_stream(
            tapi.Request(rid=0, tokens=[1], max_new_tokens=1), {}))
    assert server._streams == {} and server.engine.running == []


def test_disconnect_timeout_aborts_stalled_consumer(pair):
    p0, p1 = _prompts(2, seed=12, lo=10, hi=12)
    r_stall = tapi.Request(rid=0, tokens=p0, max_new_tokens=24,
                           decoder="speculative")
    r_live = tapi.Request(rid=1, tokens=p1, max_new_tokens=24)
    server = pair[1].serve_async(_ec(tapi, sanitize=True), gen=_gen(tapi),
                                 disconnect_timeout_s=0.05)
    eng = server.engine
    real_step = eng.step

    def paced_step():               # >= 20 ms a step: the stall outlasts
        import time                 # the 50 ms timeout deterministically
        time.sleep(0.02)
        return real_step()

    eng.step = paced_step

    async def drive():
        async with server:
            s0 = server.submit(r_stall)
            t1 = asyncio.create_task(_consume(server.submit(r_live)))
            got = []
            async for tok in s0:
                got.append(tok)
                if len(got) == 2:
                    await asyncio.sleep(0.5)     # consumer goes silent
            return got, await t1, s0

    got, out1, s0 = asyncio.run(drive())
    assert r_stall.aborted and s0.aborted and s0.disconnected
    assert 2 <= len(got) < 24
    assert len(out1) == 24 and not r_live.aborted
    assert server.disconnects == 1
    assert eng.kv_committed_tokens() == 0
    assert all(r is None for r in eng.slot_req)
    assert eng._decoders["speculative"].bound_slots() == set()
    s = server.summary()
    assert s["aborted"] == 1 and s["finished"] == 1 and s["disconnects"] == 1


def test_waiting_consumer_is_not_a_disconnect(pair):
    server = pair[1].serve_async(_ec(tapi), gen=_gen(tapi),
                                 disconnect_timeout_s=1e-9)
    out = _serve_on(server, [tapi.Request(rid=0,
                                          tokens=_prompts(1, seed=13)[0],
                                          max_new_tokens=MAX_NEW)])
    assert len(out[0]) == MAX_NEW
    assert server.disconnects == 0


# -------------------------------------------------- slack admission --

@pytest.mark.parametrize("order", ["fifo", "slack"])
def test_deferred_queue_order(pair, order):
    prompts = _prompts(3, seed=14, lo=12, hi=15)

    def scenario(ns, lvlm):
        api = ns.api
        r0, relaxed, urgent = _reqs(api, prompts)
        relaxed.slo.ttft_ms = 60_000.0
        urgent.slo.ttft_ms = 1.0
        adm = api.AdmissionConfig(high_watermark=0.9, low_watermark=0.9,
                                  max_inflight=1, order=order)
        server = lvlm.serve_async(_ec(api), gen=_gen(api), admission=adm)

        async def drive():
            async with server:
                s0 = server.submit(r0)
                s_relaxed = server.submit(relaxed)
                s_urgent = server.submit(urgent)
                outs = await asyncio.gather(_consume(s0),
                                            _consume(s_relaxed),
                                            _consume(s_urgent))
                return outs, s_relaxed.admit_clock, s_urgent.admit_clock

        outs, t_relaxed, t_urgent = asyncio.run(drive())
        return (outs, t_relaxed, t_urgent, server.admission.deferrals,
                _records(server))

    ref, port = _both(pair, scenario)
    outs, t_relaxed, t_urgent, deferrals, _ = port
    assert all(len(o) == MAX_NEW for o in outs) and deferrals == 2
    assert (t_urgent < t_relaxed) if order == "slack" \
        else (t_relaxed < t_urgent)
    assert port == ref


# ------------------------------------------------------------ metrics --

def test_metrics_registry_shared_and_slo_flags(pair):
    prompts = _prompts(2, seed=9)

    def scenario(ns, lvlm):
        api = ns.api
        reg = ns.MetricsRegistry()
        for _k in range(2):
            reqs = _reqs(api, prompts)
            reqs[0].slo.ttft_ms = 1e-9                # impossible target
            _serve_on(lvlm.serve_async(_ec(api), gen=_gen(api),
                                       metrics=reg), reqs)
        return _records(reg), reg.summary()

    ref, port = _both(pair, scenario)
    records, s = port
    assert len(records) == 4 and s["finished"] == 4
    assert s["slo_ttft_attainment"] == 0.5
    assert all(not r["ttft_ok"] for r in records if r["rid"] == 0)
    assert all(r["decoder"] == "greedy" for r in records)
    assert port == ref


# ------------------------------------------------------- KV pressure --

def test_engine_near_full_kv_pool_defers_not_crashes(pair):
    """A narrowed KV budget saturates before the slot pool: the continuous
    batcher defers admissions, committed KV stays within capacity, every
    request finishes, and the port steps exactly as the reference."""
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(1, 512, size=36)) for _ in range(4)]

    def scenario(ns, lvlm):
        api = ns.api
        eng = lvlm._serve_engine(api.EngineConfig(
            max_batch=4, cache_len=64, kv_capacity_tokens=96,
            temperature=0.0), _gen(api, max_new_tokens=8), None)
        reqs = _reqs(api, prompts, new=8)
        for r in reqs:
            eng.submit(r)                 # each needs 48 -> only 2 fit
        assert eng.kv_request_tokens(reqs[0]) == 48
        used = []
        while eng.step():
            used.append(eng.kv_committed_tokens(include_waiting=False))
        return used, _tokens(reqs), [r.jct() for r in reqs]

    ref, port = _both(pair, scenario)
    used, toks, _ = port
    assert max(used) == 96 and all(u <= 96 for u in used)
    assert all(len(t) == 8 for t in toks.values())
    assert port == ref


def test_spec_gamma_reservation_respected_at_boundary(pair):
    """Two speculative requests fit together without the gamma lookahead
    but not with it: the scheduler serialises them, and the tokens equal
    the unconstrained run's and the reference's."""
    rng = np.random.RandomState(12)
    prompts = [list(rng.randint(1, 512, size=10)) for _ in range(2)]

    def scenario(ns, lvlm):
        api = ns.api
        gen = _gen(api, max_new_tokens=5, gamma=4)

        def run(kv_cap):
            reqs = _reqs(api, prompts, new=5,
                         decoders=["speculative"] * 2)
            eng = lvlm._serve_engine(api.EngineConfig(
                max_batch=2, cache_len=64, temperature=0.0,
                kv_capacity_tokens=kv_cap), gen, None)
            for r in reqs:
                eng.submit(r)
            assert all(eng.kv_request_tokens(r) == 32 for r in reqs)
            peak = 0
            while eng.step():
                peak = max(peak, len(eng.running))
            return _tokens(reqs), peak
        return run(48), run(None)

    ref, port = _both(pair, scenario)
    (tight, tight_peak), (loose, loose_peak) = port
    assert (tight_peak, loose_peak) == (1, 2)
    assert tight == loose
    assert port == ref


@pytest.mark.parametrize("gamma", [8, 12])
def test_long_gamma_speculative_serve_matches_reference(pair, gamma):
    """Speculative serves at gamma 8 and 12 (verifies of 9 and 13 tokens,
    which the paged kernel's multi-query mode now takes on the card):
    tokens, clocks and decoder stats equal the reference's, and every
    speculative stream equals greedy."""
    prompts = _prompts(3, seed=16)

    def scenario(ns, lvlm):
        api = ns.api
        ec = _ec(api, cache_len=64)
        spec = lvlm.serve(_reqs(api, prompts, new=10), ec,
                          gen=_gen(api, decoder="speculative",
                                   max_new_tokens=10, gamma=gamma))
        greedy = lvlm.serve(_reqs(api, prompts, new=10), ec,
                            gen=_gen(api, max_new_tokens=10))
        assert _tokens(spec.requests) == _tokens(greedy.requests)
        return (_tokens(spec.requests),
                [(r.ttft(), r.tpot(), r.jct()) for r in spec.requests],
                {k: v for k, v in spec.stats.items()
                 if k != "decode_cost_by_group"},
                spec.stats["decode_cost_by_group"])

    ref, port = _both(pair, scenario)
    assert port == ref
