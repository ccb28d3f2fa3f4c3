"""The port's multi-engine ``Router`` (``repro_torch.cluster``) against
the JAX reference (``repro.cluster``), float32 phi4-mini smoke on the CPU.

Same weights through the bridge, same prompts, the same scenario run
through both packages. The cases of ``tests/test_cluster.py`` are held
on the port, and where a scenario runs on both packages its streams,
dispatch order (which replica served each rid), per-replica records,
``ClusterMetrics.summary()``, Prometheus text (``metrics_snapshot()``)
and trace events (every field but the wall clock ``wt``) equal the
reference's exactly:

  * one replica behind the router streams exactly the bare server's
    tokens (mixed decoder strategies);
  * with 2+ replicas every request completes exactly once under each of
    the three routing policies, in the reference's dispatch order;
  * failover: a killed pump's queued-but-unstarted requests complete on
    the survivor, a started stream re-raises instead of re-running;
  * parking while every replica drains, undrain, cancel of a parked or
    gate-parked stream, an all-dead fleet;
  * prefix affinity beats round-robin on shared-prefix traffic and
    converges a cold family on one replica;
  * SLO-slack admission never starves a request (hypothesis shim).
"""
import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
import repro.api as japi
from repro.obs import Tracer as JTracer
from repro.training.checkpoint import _flatten
import repro_torch.api as tapi
from repro_torch.cluster import ROUTING_POLICIES, make_policy
from repro_torch.cluster.policies import (LeastKVPolicy,
                                          PrefixAffinityPolicy,
                                          RoundRobinPolicy)
from repro_torch.models.convert import params_from_flat
from repro_torch.obs import Tracer
from repro_torch.serving.admission import AdmissionController

MAX_NEW = 6
MIXED = ["speculative", "greedy", "early_exit", "sampling"]
REF = SimpleNamespace(api=japi, Tracer=JTracer)
PORT = SimpleNamespace(api=tapi, Tracer=Tracer)


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


def _gen(api, **kw):
    base = dict(decoder="greedy", temperature=0.0, max_new_tokens=MAX_NEW,
                gamma=3)
    base.update(kw)
    return api.GenerationConfig(**base)


def _ec(api, **kw):
    base = dict(max_batch=4, cache_len=96, temperature=0.0)
    base.update(kw)
    return api.EngineConfig(**base)


def _prompts(n, seed=0, lo=8, hi=16, shared=0):
    rng = np.random.RandomState(seed)
    pre = list(rng.randint(1, 512, size=shared)) if shared else []
    return [pre + list(rng.randint(1, 512, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _reqs(api, prompts, new=MAX_NEW, decoders=None):
    reqs = [api.Request(rid=i, tokens=list(p), max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r, d in zip(reqs, decoders or ()):
        r.decoder = d
    return reqs


async def _consume(stream):
    return [tok async for tok in stream]


def _drive_all(front, reqs):
    async def drive():
        async with front:
            return await asyncio.gather(
                *(_consume(front.submit(r)) for r in reqs))

    outs = asyncio.run(drive())
    return {r.rid: list(o) for r, o in zip(reqs, outs)}


def _fleet(router):
    reps = router.replicas
    return dict(
        records=[[dataclasses.asdict(r) for r in rep.server.metrics.records]
                 for rep in reps],
        finished=[sorted(r.rid for r in rep.server.engine.finished)
                  for rep in reps],
        dispatched=[rep.dispatched for rep in reps],
        committed=[rep.server.engine.kv_committed_tokens() for rep in reps],
        summary=router.summary())


# ------------------------------------------------- 1-replica identity --


def test_single_replica_router_bit_identical_to_server(pair):
    """Router(1 replica) adds nothing observable: mixed strategies stream
    the bare async server's tokens, in both packages alike."""
    prompts = _prompts(4, seed=3)

    def scenario(ns, lvlm):
        api = ns.api
        bare = _drive_all(lvlm.serve_async(_ec(api), gen=_gen(api)),
                          _reqs(api, prompts, decoders=MIXED))
        router = lvlm.serve_cluster(1, _ec(api), gen=_gen(api))
        got = _drive_all(router, _reqs(api, prompts, decoders=MIXED))
        assert got == bare
        return got, _fleet(router)

    ref, port = _both(pair, scenario)
    assert port == ref


# ------------------------------------------------------- exactly once --


@pytest.mark.parametrize("routing", sorted(ROUTING_POLICIES))
def test_every_request_completes_exactly_once_in_reference_order(pair,
                                                                 routing):
    """Every policy spreads 8 requests over 2 replicas exactly once; the
    replica each rid ran on, the records and the summary equal the
    reference's."""
    prompts = _prompts(8, seed=4)

    def scenario(ns, lvlm):
        api = ns.api
        router = lvlm.serve_cluster(
            2, _ec(api, cache_len=128, prefix_cache=True), gen=_gen(api),
            routing=routing)
        reqs = _reqs(api, prompts)
        got = _drive_all(router, reqs)
        return got, _fleet(router)

    ref, port = _both(pair, scenario)
    got, fleet = port
    assert all(len(o) == MAX_NEW for o in got.values())
    assert sorted(sum(fleet["finished"], [])) == list(range(8))
    s = fleet["summary"]
    assert s["finished"] == 8 and s["aborted"] == 0 and s["failovers"] == 0
    assert s["routing_policy"] == routing
    assert s["dispatched_by_replica"] == fleet["dispatched"]
    assert s["completed_by_replica"] == [len(f) for f in fleet["finished"]]
    if routing != "prefix_affinity":
        assert all(d > 0 for d in fleet["dispatched"])
    clocks = s["virtual_time_by_replica"]
    assert s["virtual_time_s"] == max(clocks)
    assert s["fleet_throughput_tok_per_s"] == pytest.approx(
        s["tokens"] / max(clocks))
    assert port == ref


def test_policy_registry_and_custom_policy():
    assert set(ROUTING_POLICIES) == {"round_robin", "least_kv",
                                     "prefix_affinity"}
    assert isinstance(make_policy("round_robin"), RoundRobinPolicy)
    assert isinstance(make_policy("least_kv"), LeastKVPolicy)
    assert isinstance(make_policy("prefix_affinity"), PrefixAffinityPolicy)
    custom = SimpleNamespace(name="first", pick=lambda req, cands: cands[0])
    assert make_policy(custom) is custom
    with pytest.raises(ValueError, match="unknown routing policy"):
        make_policy("random")
    with pytest.raises(TypeError):
        make_policy(object())


def test_duplicate_rid_rejected_fleet_wide(pair):
    router = pair[1].serve_cluster(2, _ec(tapi), gen=_gen(tapi))

    async def drive():
        async with router:
            s = router.submit(tapi.Request(rid=0, tokens=[1, 2, 3],
                                           max_new_tokens=2))
            with pytest.raises(ValueError):
                router.submit(tapi.Request(rid=0, tokens=[4],
                                           max_new_tokens=1))
            return await _consume(s)

    assert len(asyncio.run(drive())) == 2


# ----------------------------------------------------------- failover --


def _boom():
    raise RuntimeError("injected replica failure")


def test_failover_on_killed_pump_loses_no_queued_request(pair):
    """Replica 0's pump dies before its requests start: they fail over to
    replica 1 and complete exactly once; the fleet state equals the
    reference's."""
    prompts = _prompts(4, seed=5)

    def scenario(ns, lvlm):
        api = ns.api
        router = lvlm.serve_cluster(2, _ec(api), gen=_gen(api))

        async def drive():
            async with router:
                streams = [router.submit(r) for r in _reqs(api, prompts)]
                router.replicas[0].server.engine.step = _boom
                return await asyncio.gather(*(_consume(s) for s in streams))

        outs = asyncio.run(drive())
        state = [rep.state for rep in router.replicas]
        err = type(router.replicas[0].error)
        return (outs, router.failovers, state, err, _fleet(router),
                router.metrics.per_replica())

    ref, port = _both(pair, scenario)
    outs, failovers, state, err, fleet, per = port
    assert per[0]["error"] == repr(RuntimeError("injected replica failure"))
    assert all(len(o) == MAX_NEW for o in outs)
    assert failovers == 2 and state == ["dead", "ok"]
    assert err is RuntimeError
    assert fleet["finished"] == [[], [0, 1, 2, 3]]
    assert fleet["committed"][1] == 0
    assert fleet["summary"]["finished"] == 4
    assert port == ref


def test_failover_does_not_rerun_started_streams(pair):
    req = tapi.Request(rid=0, tokens=_prompts(1, seed=6)[0],
                       max_new_tokens=24)
    router = pair[1].serve_cluster(2, _ec(tapi), gen=_gen(tapi))

    def mid_boom():
        raise RuntimeError("injected mid-stream failure")

    async def drive():
        async with router:
            stream = router.submit(req)
            got = []
            with pytest.raises(RuntimeError, match="mid-stream"):
                async for tok in stream:
                    got.append(tok)
                    if len(got) == 2:
                        stream.replica.server.engine.step = mid_boom
            return got

    got = asyncio.run(drive())
    assert len(got) >= 2 and router.failovers == 0
    dead = next(rep for rep in router.replicas if rep.dead)
    other = next(rep for rep in router.replicas if not rep.dead)
    assert other.server.engine.finished == []
    assert dead.dispatched == 1 and other.dispatched == 0


def test_all_draining_parks_submit_until_undrain(pair):
    router = pair[1].serve_cluster(1, _ec(tapi), gen=_gen(tapi))

    async def drive():
        async with router:
            router.drain(0)
            stream = router.submit(tapi.Request(rid=0, tokens=[1, 2, 3],
                                                max_new_tokens=2))
            assert stream.parked and stream.replica is None
            task = asyncio.create_task(_consume(stream))
            await asyncio.sleep(0.01)
            assert not task.done() and not stream._done
            router.undrain(0)
            out = await task
            assert stream.replica.index == 0
            return out

    assert len(asyncio.run(drive())) == 2
    assert router._streams == {} and router._parked == []
    assert router.summary()["finished"] == 1


def test_parked_submit_cancel_frees_router_state(pair):
    router = pair[1].serve_cluster(1, _ec(tapi), gen=_gen(tapi))

    async def drive():
        async with router:
            router.drain(0)
            stream = router.submit(tapi.Request(rid=0, tokens=[1],
                                                max_new_tokens=1))
            assert stream.parked
            stream.cancel()
            assert 0 not in router._streams and router._parked == []
            router.undrain(0)
            return await _consume(router.submit(tapi.Request(
                rid=0, tokens=[1, 2], max_new_tokens=2)))

    assert len(asyncio.run(drive())) == 2


def test_all_dead_fleet_raises_on_submit(pair):
    router = pair[1].serve_cluster(1, _ec(tapi), gen=_gen(tapi))

    async def drive():
        async with router:
            router.replicas[0].server.engine.step = _boom
            with pytest.raises(RuntimeError):
                await _consume(router.submit(tapi.Request(
                    rid=0, tokens=[1], max_new_tokens=1)))
            with pytest.raises(RuntimeError, match="no live replica"):
                router.submit(tapi.Request(rid=1, tokens=[1],
                                           max_new_tokens=1))

    asyncio.run(drive())


# ----------------------------------------------------- prefix affinity --


def test_prefix_affinity_beats_round_robin_on_shared_prefix(pair):
    prompts = _prompts(6, seed=7, lo=4, hi=8, shared=32)

    def scenario(ns, lvlm):
        hits = {}
        for routing in ("round_robin", "prefix_affinity"):
            router = lvlm.serve_cluster(
                2, _ec(ns.api, cache_len=128, prefix_cache=True),
                gen=_gen(ns.api), routing=routing)
            got = _drive_all(router, _reqs(ns.api, prompts, new=4))
            assert all(len(o) == 4 for o in got.values())
            hits[routing] = router.summary()["prefix_hit_tokens"]
        return hits

    ref, port = _both(pair, scenario)
    assert port["prefix_affinity"] > port["round_robin"] > 0
    assert port == ref


def test_prefix_affinity_converges_cold_prefixes(pair):
    prompts = _prompts(4, seed=8, lo=4, hi=8, shared=32)
    router = pair[1].serve_cluster(
        2, _ec(tapi, cache_len=128, prefix_cache=True), gen=_gen(tapi),
        routing="prefix_affinity")
    _drive_all(router, _reqs(tapi, prompts, new=4))
    assert sorted(rep.dispatched for rep in router.replicas) == [0, 4]


# -------------------------------------------------------------- drain --


def test_drain_lifecycle(pair):
    """Draining with migration refused by the least-KV fleet's timing:
    in-flight streams finish, no new work lands on the drained replica,
    undrain rejoins it; the fleet state equals the reference's."""
    p = _prompts(6, seed=9)

    def scenario(ns, lvlm):
        api = ns.api
        router = lvlm.serve_cluster(2, _ec(api), gen=_gen(api),
                                    routing="least_kv")

        def req(i):
            return api.Request(rid=i, tokens=p[i], max_new_tokens=MAX_NEW)

        async def drive():
            async with router:
                first = router.submit(req(0))
                assert first.replica.index == 0
                router.drain(0)
                mid = await asyncio.gather(*(
                    _consume(router.submit(req(i))) for i in (1, 2)))
                out_first = await _consume(first)
                router.undrain(0)
                last = router.submit(req(3))
                out_last = await _consume(last)
                return out_first, mid, out_last, last.replica.index

        return asyncio.run(drive()), _fleet(router)

    ref, port = _both(pair, scenario)
    (out_first, mid, out_last, last_idx), fleet = port
    assert len(out_first) == MAX_NEW and len(out_last) == MAX_NEW
    assert all(len(o) == MAX_NEW for o in mid)
    assert sum(fleet["dispatched"]) == 4 and fleet["dispatched"][1] >= 2
    assert last_idx == 0
    assert fleet["summary"]["finished"] == 4
    assert port == ref


# -------------------------------------------- server-initiated aborts --


def test_disconnect_through_router_frees_rid_and_inflight(pair):
    router = pair[1].serve_cluster(1, _ec(tapi), gen=_gen(tapi),
                                   disconnect_timeout_s=0.05)
    eng = router.replicas[0].server.engine
    real_step = eng.step

    def paced_step():
        import time
        time.sleep(0.02)
        return real_step()

    eng.step = paced_step
    p = _prompts(2, seed=10, lo=10, hi=12)

    async def drive():
        async with router:
            hung = router.submit(tapi.Request(rid=0, tokens=p[0],
                                              max_new_tokens=24))
            await hung.__anext__()
            for _ in range(200):
                if 0 not in router._streams:
                    break
                await asyncio.sleep(0.02)
            return await _consume(router.submit(tapi.Request(
                rid=0, tokens=p[1], max_new_tokens=MAX_NEW)))

    assert len(asyncio.run(drive())) == MAX_NEW
    assert router._streams == {} and router.replicas[0].inflight == {}
    assert router.replicas[0].server.disconnects == 1
    assert eng.kv_committed_tokens() == 0


def test_cancelled_consumer_task_frees_router_state(pair):
    router = pair[1].serve_cluster(
        1, _ec(tapi, max_batch=1, cache_len=64), gen=_gen(tapi),
        admission=tapi.AdmissionConfig(high_watermark=0.3,
                                       low_watermark=0.3))

    async def drive():
        async with router:
            r0 = tapi.Request(rid=0, tokens=_prompts(1, seed=11, lo=12,
                                                     hi=13)[0],
                              max_new_tokens=16)
            r1 = tapi.Request(rid=1, tokens=[1, 2, 3],
                              max_new_tokens=MAX_NEW)
            t0 = asyncio.create_task(_consume(router.submit(r0)))
            await asyncio.sleep(0)
            t1 = asyncio.create_task(_consume(router.submit(r1)))
            await asyncio.sleep(0)
            t1.cancel()
            with pytest.raises(asyncio.CancelledError):
                await t1
            assert 1 not in router._streams
            assert 1 not in router.replicas[0].inflight
            assert router.replicas[0].kv_load() > 0
            return await t0

    assert len(asyncio.run(drive())) == 16
    assert router._streams == {} and router.replicas[0].inflight == {}
    assert router.summary()["finished"] == 1


# ------------------------------------------ metrics, Prometheus, trace --


def test_cluster_metrics_prometheus_and_trace_equal_reference(pair):
    """A traced disaggregated fleet with a shared prefix tier: per-replica
    summaries, the fleet summary, ``metrics_snapshot()`` text and every
    trace event but its wall clock equal the reference's."""
    prompts = _prompts(4, seed=16, lo=4, hi=8, shared=16)

    def scenario(ns, lvlm):
        api = ns.api
        tracer = ns.Tracer()
        router = lvlm.serve_cluster(
            3, _ec(api, cache_len=128, prefix_cache=True,
                   cost=api.CostModel(kv_bytes_per_token=4096)),
            gen=_gen(api), roles=["prefill", "decode", "unified"],
            routing="least_kv", obs=tracer)
        got = _drive_all(router, _reqs(api, prompts))
        events = [{k: v for k, v in ev.items() if k != "wt"}
                  for ev in tracer.events]
        return (got, router.metrics.per_replica(), router.summary(),
                router.metrics_snapshot(), events, tracer.open_spans())

    ref, port = _both(pair, scenario)
    _, per, summary, text, events, open_spans = port
    assert summary["disaggregation"]["migrations"] >= 1
    assert "repro_migrations_total" in text and 'replica="2"' in text
    assert any(ev.get("name") == "kv_migration" for ev in events)
    assert open_spans == []
    assert port == ref


# ------------------------------------- SLO-slack starvation freedom --


class _FakeEngine:
    """Duck-typed engine for AdmissionController: KV accounting and a
    finish_one() tick, no model."""

    def __init__(self, capacity):
        self.kv_capacity_tokens = capacity
        self.waiting = []
        self.running = []
        self.clock = 0.0

    def kv_request_tokens(self, req):
        need = req.prompt_len + req.max_new_tokens
        return ((need + 15) // 16) * 16

    def kv_committed_tokens(self, include_waiting=True):
        return sum(self.kv_request_tokens(r) for r in self.running)

    def submit(self, req):
        req.arrival = max(req.arrival, self.clock)
        self.running.append(req)

    def finish_one(self):
        if self.running:
            self.running.pop(0)
            self.clock += 1.0


@given(spec=st.lists(
    st.tuples(st.integers(min_value=1, max_value=3),
              st.floats(min_value=1.0, max_value=60_000.0)),
    min_size=4, max_size=12))
@settings(max_examples=15, deadline=None)
def test_slack_reordering_never_starves(spec):
    """Under constant saturation, with a second wave of tight deadlines
    landing mid-run, every request admitted under SLO-slack order on the
    port's admission gate eventually starts."""
    async def scenario():
        eng = _FakeEngine(capacity=96)
        ctl = AdmissionController(
            tapi.AdmissionConfig(high_watermark=0.5, low_watermark=0.5,
                                 order="slack"), eng)
        ctl.order_key = lambda r: (
            max(r.arrival, getattr(r, "_gate_clock", 0.0))
            + r.slo.ttft_ms * 1e-3 - eng.clock)
        reqs = []
        for i, (blocks, slo_ms) in enumerate(spec):
            r = tapi.Request(rid=i, tokens=[1] * (blocks * 16 - 4),
                             max_new_tokens=4)
            r.slo.ttft_ms = slo_ms
            reqs.append(r)
        half = len(reqs) // 2
        tasks = [asyncio.ensure_future(ctl.admit(r)) for r in reqs[:half]]
        for tick in range(20 * len(reqs) + 20):
            await asyncio.sleep(0)
            if tick == 3:
                tasks += [asyncio.ensure_future(ctl.admit(r))
                          for r in reqs[half:]]
            eng.finish_one()
            ctl.maybe_admit()
            if len(tasks) == len(reqs) and all(t.done() for t in tasks):
                break
        assert len(tasks) == len(reqs) and all(t.done() for t in tasks), \
            "a request starved at the admission gate"
        assert all(await asyncio.gather(*tasks))
        assert ctl.queue_depth == 0

    asyncio.run(scenario())
