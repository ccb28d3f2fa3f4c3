"""The port's disaggregated serving (``repro_torch.cluster`` roles, live
KV migration, the cluster-shared prefix tier, the pool simulators)
against the JAX reference, float32 phi4-mini smoke on the CPU.

Same weights through the bridge, same prompts, the same scenario run
through both packages; every case of ``tests/test_disaggregation.py`` is
held on the port, and the port's streams, per-replica ``RequestRecord``s
(TTFT / TPOT / JCT / queue wait on the virtual clock), fleet ``summary()``
(its ``disaggregation`` block included), migration records and
``migrated_in`` / ``migrated_out`` equal the reference's exactly. Engines
run with the sanitizer on. Besides:

  * ``simulate_disaggregated``, ``simulate_colocated`` and ``goodput``
    give the reference's summaries on the same ``PoolConfig``;
  * an export ticket is a clone: after the source slot is reused by
    another request the ticket (and the rows imported from it) still
    hold the migrated request's KV, bit for bit;
  * a shared-tier snapshot is unchanged after its publishing slot is
    reused;
  * a heterogeneous fleet (a decode replica with a longer ``cache_len``)
    migrates and refuses exactly where the reference does.
"""
import asyncio
import dataclasses
import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.cluster import SharedPrefixTier as JSharedPrefixTier
from repro.core.serving import disaggregation as jdis
from repro.roofline.hw import KV_LINK_GBPS as J_KV_LINK_GBPS
from repro.training.checkpoint import _flatten
import repro_torch.api as tapi
from repro_torch.cluster import Router, SharedPrefixTier
from repro_torch.core.kv_cache.tiered import TierStats
from repro_torch.core.serving import disaggregation as tdis
from repro_torch.core.serving.engine import Engine
from repro_torch.core.serving.request import State
from repro_torch.models.convert import params_from_flat
from repro_torch.roofline.hw import KV_LINK_GBPS
from repro_torch.serving import MetricsRegistry

MAX_NEW = 6
REF = SimpleNamespace(api=japi, dis=jdis)
PORT = SimpleNamespace(api=tapi, dis=tdis)


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
    base = dict(decoder="greedy", temperature=0.0, max_new_tokens=MAX_NEW)
    base.update(kw)
    return api.GenerationConfig(**base)


def _ec(api, **kw):
    base = dict(max_batch=4, cache_len=96, temperature=0.0, sanitize=True)
    base.update(kw)
    return api.EngineConfig(**base)


def _prompts(n, seed=0, lo=8, hi=16, shared=0):
    rng = np.random.RandomState(seed)
    pre = list(rng.randint(1, 512, size=shared)) if shared else []
    return [pre + list(rng.randint(1, 512, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _reqs(api, prompts, new=MAX_NEW):
    return [api.Request(rid=i, tokens=list(p), max_new_tokens=new)
            for i, p in enumerate(prompts)]


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
    """Everything a fleet run leaves behind that both packages must agree
    on: per-replica records, finished rids, migration counts and KV, the
    router's migration log and the fleet summary."""
    reps = router.replicas
    return dict(
        records=[[dataclasses.asdict(r) for r in rep.server.metrics.records]
                 for rep in reps],
        finished=[sorted(r.rid for r in rep.server.engine.finished)
                  for rep in reps],
        migrated=[(rep.migrated_in, rep.migrated_out) for rep in reps],
        committed=[rep.server.engine.kv_committed_tokens() for rep in reps],
        exports=[sorted(rep.server.engine._exports) for rep in reps],
        migrations=list(router.migrations),
        summary=router.summary())


# --------------------------------------------------- roles: prefill/decode --


def test_prefill_decode_roles_hand_off_every_request(pair):
    """prefill:1,decode:1 -- every request prefills on replica 0,
    decodes and finishes on replica 1, exactly once; streams equal the
    colocated fleet's, and everything equals the reference's."""
    prompts = _prompts(4, seed=3)

    def scenario(ns, lvlm):
        api = ns.api
        ref = _drive_all(lvlm.serve_cluster(2, _ec(api), gen=_gen(api)),
                         _reqs(api, prompts))
        router = lvlm.serve_cluster(2, _ec(api), gen=_gen(api),
                                    roles=["prefill", "decode"])
        got = _drive_all(router, _reqs(api, prompts))
        assert got == ref
        pf, dec = router.replicas
        return got, (pf.role, dec.role, pf.dispatched, dec.dispatched), \
            _fleet(router)

    ref, port = _both(pair, scenario)
    _, roles, fleet = port
    assert roles == ("prefill", "decode", 4, 0)
    assert fleet["migrated"] == [(0, 4), (4, 0)]
    assert fleet["finished"] == [[], [0, 1, 2, 3]]
    assert fleet["committed"] == [0, 0]
    assert len(fleet["migrations"]) == 4
    s = fleet["summary"]
    assert s["finished"] == 4 and s["aborted"] == 0
    assert s["replica_roles"] == ["prefill", "decode"]
    assert s["disaggregation"]["migrations"] == 4
    assert s["disaggregation"]["migrated_out_by_replica"] == [4, 0]
    assert s["disaggregation"]["migrated_in_by_replica"] == [0, 4]
    assert port == ref


def test_roles_validation(pair):
    t = pair[1]
    gen = _gen(tapi)
    with pytest.raises(ValueError, match="decode-capable"):
        t.serve_cluster(2, _ec(tapi), gen=gen, roles=["prefill", "prefill"])
    with pytest.raises(ValueError, match="prefill-capable"):
        t.serve_cluster(2, _ec(tapi), gen=gen, roles=["decode", "decode"])
    with pytest.raises(ValueError, match="entries for"):
        t.serve_cluster(2, _ec(tapi), gen=gen, roles=["unified"])
    with pytest.raises(ValueError, match="unknown replica role"):
        Router([t.serve_async(_ec(tapi), gen=gen)], roles=["chonk"])
    # per-replica spec dicts may carry the role instead
    router = t.serve_cluster([{"role": "prefill"}, {"role": "decode"}],
                             _ec(tapi), gen=gen)
    assert [rep.role for rep in router.replicas] == ["prefill", "decode"]
    # one LVLM behind the fleet: every replica holds the same weights
    p0 = router.replicas[0].server.engine.params
    p1 = router.replicas[1].server.engine.params
    assert p0["embed"]["tok"] is p1["embed"]["tok"] is t.params["embed"][
        "tok"]


def test_transfer_cost_lands_on_importer_clock(pair):
    """With kv_bytes_per_token > 0 the KV-link transfer is a real
    virtual-clock cost on the importer, equal to the reference's."""
    prompts = _prompts(2, seed=4)

    def scenario(ns, lvlm):
        api = ns.api
        cost = api.CostModel(kv_bytes_per_token=2 << 20)
        router = lvlm.serve_cluster(2, _ec(api, cost=cost), gen=_gen(api),
                                    roles=["prefill", "decode"])
        got = _drive_all(router, _reqs(api, prompts))
        return got, router.replicas[1].server.engine.clock, _fleet(router)

    ref, port = _both(pair, scenario)
    got, dec_clock, fleet = port
    assert all(len(o) == MAX_NEW for o in got.values())
    assert len(fleet["migrations"]) == 2
    for m in fleet["migrations"]:
        expect = (2 << 20) * m["kv_tokens"] / (KV_LINK_GBPS * 1e9)
        assert m["transfer_s"] == pytest.approx(expect) and expect > 0
        assert dec_clock >= m["transfer_s"]
    d = fleet["summary"]["disaggregation"]
    assert d["prefill_s_mean"] is not None and d["prefill_s_mean"] > 0
    assert port == ref


def test_handoff_reserves_prefill_only_kv(pair):
    """A handoff request reserves its prompt plus one token on the
    prefill engine; imported, the full decode budget counts again."""
    def scenario(ns, lvlm):
        eng = lvlm.serve_async(_ec(ns.api), gen=_gen(ns.api)).engine
        req = ns.api.Request(rid=0, tokens=[1] * 20, max_new_tokens=16)
        full = eng.kv_request_tokens(req)
        req.handoff = True
        light = eng.kv_request_tokens(req)
        req._imported = True
        return full, light, eng.kv_request_tokens(req), eng._kv_block()

    ref, port = _both(pair, scenario)
    full, light, imported, bs = port
    assert light == ((20 + 1 + bs - 1) // bs) * bs < full == imported
    assert port == ref


# ------------------------------------------------------- drain migration --


def test_drain_migrates_live_kv_token_identical(pair):
    """Drain with live requests: the drained replica's in-flight KV moves
    to the sibling, every stream equals an undrained run, and the fleet
    state equals the reference's (sanitizer on throughout)."""
    prompts = _prompts(3, seed=5)

    def scenario(ns, lvlm):
        api = ns.api
        baseline = _drive_all(lvlm.serve_cluster(2, _ec(api), gen=_gen(api)),
                              _reqs(api, prompts, new=12))
        router = lvlm.serve_cluster(2, _ec(api), gen=_gen(api))

        async def drive():
            async with router:
                streams = [router.submit(r)
                           for r in _reqs(api, prompts, new=12)]
                assert streams[0].replica.index == 0
                got0 = [await streams[0].__anext__(),
                        await streams[0].__anext__()]
                router.drain(0)
                rest = await asyncio.gather(*(_consume(s) for s in streams))
                return [got0 + rest[0]] + rest[1:]

        outs = dict(enumerate(asyncio.run(drive())))
        assert outs == baseline
        return outs, _fleet(router)

    ref, port = _both(pair, scenario)
    _, fleet = port
    assert fleet["migrated"][0][1] >= 1
    assert any(m["rid"] == 0 and m["src"] == 0 and m["dst"] == 1
               for m in fleet["migrations"])
    assert 0 in fleet["finished"][1]
    assert fleet["committed"][0] == 0
    assert fleet["summary"]["finished"] == 3
    assert port == ref


def test_drain_without_sibling_finishes_in_place(pair):
    def scenario(ns, lvlm):
        api = ns.api
        router = lvlm.serve_cluster(1, _ec(api), gen=_gen(api))

        async def drive():
            async with router:
                stream = router.submit(api.Request(
                    rid=0, tokens=[1, 2, 3, 4], max_new_tokens=MAX_NEW))
                first = await stream.__anext__()
                router.drain(0)
                return [first] + await _consume(stream)

        return asyncio.run(drive()), _fleet(router)

    ref, port = _both(pair, scenario)
    out, fleet = port
    assert len(out) == MAX_NEW
    assert fleet["migrations"] == [] and fleet["migrated"] == [(0, 0)]
    assert fleet["finished"] == [[0]]
    assert port == ref


# --------------------------------------------- exactly-once under failure --


async def _broken_import(request, ticket, *, ready_at=0.0):
    raise RuntimeError("injected import failure (dead importer)")


def test_import_failure_retries_next_decode_replica(pair):
    """The first decode target refuses every import: the router retries
    the next one with the same ticket, and each request completes
    exactly once, with the colocated run's tokens."""
    prompts = _prompts(2, seed=6)

    def scenario(ns, lvlm):
        api = ns.api
        ref = _drive_all(lvlm.serve_cluster(2, _ec(api), gen=_gen(api)),
                         _reqs(api, prompts))
        router = lvlm.serve_cluster(3, _ec(api), gen=_gen(api),
                                    roles=["prefill", "decode", "decode"])
        router.replicas[1].server.import_stream = _broken_import
        got = _drive_all(router, _reqs(api, prompts))
        assert got == ref
        return got, _fleet(router)

    ref, port = _both(pair, scenario)
    got, fleet = port
    assert all(len(o) == MAX_NEW for o in got.values())
    assert sorted(sum(fleet["finished"], [])) == [0, 1]
    assert [m[0] for m in fleet["migrated"]] == [0, 0, 2]
    assert all(m["dst"] == 2 for m in fleet["migrations"])
    assert port == ref


def test_import_failure_with_no_alternative_resumes_on_source(pair):
    prompts = _prompts(2, seed=7)

    def scenario(ns, lvlm):
        api = ns.api
        router = lvlm.serve_cluster(2, _ec(api), gen=_gen(api),
                                    roles=["prefill", "decode"])
        router.replicas[1].server.import_stream = _broken_import
        return _drive_all(router, _reqs(api, prompts)), _fleet(router)

    ref, port = _both(pair, scenario)
    got, fleet = port
    assert all(len(o) == MAX_NEW for o in got.values())
    assert fleet["finished"] == [[0, 1], []]
    assert fleet["migrations"] == [] and fleet["committed"][0] == 0
    assert fleet["exports"] == [[], []]
    assert port == ref


def test_heterogeneous_cache_len_fleet(pair):
    """A decode replica with a longer cache than the prefill replica takes
    every import; a decode replica too short for prompt + remaining
    tokens refuses it (``import_kv``'s capacity check) and the request
    resumes on its source -- as in the reference."""
    prompts = _prompts(2, seed=12, lo=20, hi=24)

    def scenario(ns, lvlm):
        api = ns.api
        outs = []
        for dec_len in (128, 32):
            router = lvlm.serve_cluster(
                [{"role": "prefill", "engine_cfg": _ec(api, cache_len=64)},
                 {"role": "decode",
                  "engine_cfg": _ec(api, cache_len=dec_len)}],
                gen=_gen(api, max_new_tokens=16))
            got = _drive_all(router, _reqs(api, prompts, new=16))
            outs.append((got, _fleet(router)))
        return outs

    ref, port = _both(pair, scenario)
    (long_got, long_fleet), (short_got, short_fleet) = port
    assert long_got == short_got
    assert long_fleet["migrated"] == [(0, 2), (2, 0)]
    assert short_fleet["migrated"] == [(0, 0), (0, 0)]
    assert short_fleet["finished"] == [[0, 1], []]
    assert port == ref


# ------------------------------------------------- the ticket is a clone --


def _engine(t, **kw):
    return Engine(t.model, t.params, _ec(tapi, **kw))


def _run_until(eng, cond, limit=200):
    for _ in range(limit):
        if cond():
            return
        assert eng.step()
    raise AssertionError("condition not reached")


def test_export_ticket_is_a_clone_and_import_copies_its_bits(pair):
    """``export_kv`` clones the slot's rows: after the source slot is
    released and a new request prefills into it, the ticket still holds
    the migrated request's KV, and the importer's slot rows ``[0, pos)``
    equal it bit for bit; the migrated request's tokens equal an
    unmigrated run's."""
    t = pair[1]
    prompt, other = _prompts(2, seed=13, lo=14, hi=15)
    plain = t.serve([tapi.Request(rid=0, tokens=list(prompt),
                                  max_new_tokens=MAX_NEW)],
                    _ec(tapi), gen=_gen(tapi)).requests[0].generated
    src, dst = _engine(t), _engine(t)
    req = tapi.Request(rid=0, tokens=list(prompt), max_new_tokens=MAX_NEW)
    req.handoff = True
    src.submit(req)
    _run_until(src, lambda: req.state is State.MIGRATING)
    ticket = src.export_kv(0)
    slot, pos = ticket["slot"], ticket["pos"]
    assert pos == len(prompt)
    before = {k: v.clone() for k, v in ticket["snap"]["layers"].items()}
    for k, v in ticket["snap"]["layers"].items():
        assert v.data_ptr() != src.pool["layers"][k].data_ptr()
        assert torch.equal(v[:, 0], src.pool["layers"][k][:, slot, :pos])
    dst.import_kv(req, ticket, ready_at=ticket["clock"])
    src.complete_export(0)
    assert src.slot_req[slot] is None and src._exports == {}
    # the source slot's next occupant overwrites its rows
    nxt = tapi.Request(rid=1, tokens=list(other), max_new_tokens=2)
    src.submit(nxt)
    _run_until(src, lambda: nxt.state is State.DONE)
    assert nxt._slot == slot
    assert not torch.equal(src.pool["layers"]["k"][:, slot, :pos],
                           before["k"][:, 0])
    for k, v in ticket["snap"]["layers"].items():
        assert torch.equal(v, before[k])
        assert torch.equal(dst.pool["layers"][k][:, req._slot, :pos],
                           before[k][:, 0])
    assert (dst.migrated_in, src.migrated_out) == (1, 1)
    while dst.step():
        pass
    assert req.generated == plain


def test_shared_tier_snapshot_unchanged_after_slot_reuse(pair):
    """The tier's snapshot is published from a clone: after the publishing
    slot takes another request, the tier still returns the prefix's KV
    bit for bit, and a sibling's remote hit installs exactly it."""
    t = pair[1]
    fam = _prompts(2, seed=14, lo=4, hi=6, shared=32)
    tier = SharedPrefixTier(block=16)
    a = _engine(t, max_batch=1, cache_len=128, prefix_cache=True)
    b = _engine(t, max_batch=1, cache_len=128, prefix_cache=True)
    a.prefix_share = b.prefix_share = tier
    r0 = tapi.Request(rid=0, tokens=list(fam[0]), max_new_tokens=2)
    a.submit(r0)
    _run_until(a, lambda: r0.state is State.DONE)
    k, snap = tier.lookup("none", fam[0], block=16, touch=False)
    assert k == 32
    before = {n: v.clone() for n, v in snap["layers"].items()}
    assert torch.equal(snap["layers"]["k"][:, 0],
                       a.pool["layers"]["k"][:, 0, :32])
    r1 = tapi.Request(rid=1, tokens=list(_prompts(1, seed=15, lo=40,
                                                  hi=41)[0]),
                      max_new_tokens=2)
    a.submit(r1)
    _run_until(a, lambda: r1.state is State.DONE)
    assert r1._slot == r0._slot == 0
    assert not torch.equal(a.pool["layers"]["k"][:, 0, :32],
                           before["k"][:, 0])
    for n, v in tier.lookup("none", fam[0], block=16)[1]["layers"].items():
        assert torch.equal(v, before[n])
    r2 = tapi.Request(rid=2, tokens=list(fam[1]), max_new_tokens=2)
    b.submit(r2)
    b.step()
    assert b.remote_prefix_hits == 1 and b.prefix_hit_tokens == 32
    for n in ("k", "v"):
        assert torch.equal(b.pool["layers"][n][:, 0, :32], before[n][:, 0])


# --------------------------------------------------- shared prefix tier --


@pytest.mark.parametrize("cls", [JSharedPrefixTier, SharedPrefixTier],
                         ids=["reference", "port"])
def test_shared_prefix_tier_radix_semantics(cls):
    tier = cls(block=4, cap=2)
    snap_a, snap_b = object(), object()
    tier.insert("none", list(range(8)), snap_a, 8)
    tier.insert("none", list(range(4)), snap_b, 4)
    assert tier.lookup("none", list(range(12)), block=4) == (8, snap_a)
    assert tier.lookup("none", list(range(4)) + [99] * 4,
                       block=4) == (4, snap_b)
    assert tier.lookup("fastv-0.5", list(range(8)), block=4) == (0, None)
    assert tier.lookup("none", list(range(8)), block=8) == (0, None)
    tier.insert("none", [7] * 4, object(), 4)     # evicts the LRU entry
    assert len(tier) == 2 and tier.evictions == 1
    # a block-size mismatch is refused before it counts as a miss
    assert tier.stats() == {"entries": 2, "hits": 2, "misses": 1,
                            "hit_rate": 2 / 3, "inserts": 3, "evictions": 1}
    tier2 = cls(block=4, cap=8)
    tier2.insert("none", list(range(8)), snap_a, 8)
    tier2._evict_one()
    assert tier2._roots == {}                     # fully pruned


def test_prefix_tier_shares_hits_across_replicas(pair):
    """Round-robin + shared tier: replica 1's cold prefill of a family
    replica 0 cached short-circuits through the tier; streams equal the
    tier-less run; hits, inserts and remote hits equal the reference's."""
    prompts = _prompts(4, seed=8, lo=4, hi=8, shared=32)

    def scenario(ns, lvlm):
        api = ns.api
        ec = dict(cache_len=128, prefix_cache=True)
        ref = _drive_all(lvlm.serve_cluster(2, _ec(api, **ec), gen=_gen(api),
                                            shared_prefix=False),
                         _reqs(api, prompts, new=4))
        router = lvlm.serve_cluster(2, _ec(api, **ec), gen=_gen(api),
                                    shared_prefix=True)
        got = _drive_all(router, _reqs(api, prompts, new=4))
        assert got == ref
        defaults = (
            lvlm.serve_cluster(2, _ec(api, **ec),
                               gen=_gen(api)).prefix_tier is None,
            lvlm.serve_cluster(2, _ec(api, **ec), gen=_gen(api),
                               roles=["prefill", "decode"]
                               ).prefix_tier is not None)
        return (got, router.prefix_tier.stats(),
                [rep.server.engine.remote_prefix_hits
                 for rep in router.replicas],
                router.metrics.per_replica(), defaults, _fleet(router))

    ref, port = _both(pair, scenario)
    _, stats, remote, per, defaults, _ = port
    assert stats["hits"] >= 1 and stats["inserts"] >= 1
    assert sum(remote) >= 1
    assert sum(p["remote_prefix_hits"] for p in per) == sum(remote)
    assert defaults == (True, True)
    assert port == ref


# ------------------------------------------------- satellite regressions --


def test_kv_link_bandwidth_is_one_shared_constant():
    assert KV_LINK_GBPS == J_KV_LINK_GBPS
    assert tdis.CostModel().transfer_gbps == KV_LINK_GBPS
    sig = inspect.signature(TierStats.transfer_seconds)
    assert sig.parameters["gbps"].default == KV_LINK_GBPS


def test_expected_ttft_cold_start_prior():
    m = MetricsRegistry()
    assert m.expected_ttft() == MetricsRegistry.DEFAULT_TTFT_PRIOR > 0.0
    assert MetricsRegistry(ttft_prior=1.5).expected_ttft() == 1.5
    req = tapi.Request(rid=0, tokens=[1, 2], max_new_tokens=2)
    req.arrival = 0.0
    req.generated.extend([5, 6])
    req.first_token_time = 0.03
    req.finish_time = 0.05
    m.observe(req)
    assert m.expected_ttft() == pytest.approx(0.03)


def test_cold_start_slack_orders_by_deadline(pair):
    def scenario(ns, lvlm):
        server = lvlm.serve_async(_ec(ns.api), gen=_gen(ns.api))
        tight = ns.api.Request(rid=0, tokens=[1], max_new_tokens=1)
        loose = ns.api.Request(rid=1, tokens=[1], max_new_tokens=1)
        tight.slo.ttft_ms = 50.0
        loose.slo.ttft_ms = 5000.0
        assert server.metrics.records == []
        return server._slack(tight), server._slack(loose)

    ref, port = _both(pair, scenario)
    assert port[0] < 0 < port[1]
    assert port == ref


# ----------------------------------------------------- the pool simulators --


def _sim_reqs(api, seed):
    rng = np.random.RandomState(seed)
    arr = np.cumsum(rng.exponential(0.01, size=12))
    return [api.Request(rid=i, tokens=[1] * int(rng.randint(8, 400)),
                        max_new_tokens=int(rng.randint(2, 24)),
                        arrival=float(a),
                        predicted_len=int(rng.randint(2, 24)))
            for i, a in enumerate(arr)]


@pytest.mark.parametrize("predict_len", [False, True])
def test_pool_simulators_and_goodput_equal_reference(predict_len):
    """``simulate_disaggregated`` (round-robin and ShuffleInfer-style
    predicted-length assignment), ``simulate_colocated`` and ``goodput``
    give the reference's summaries and per-request times exactly."""
    def run(ns):
        cost = ns.dis.CostModel(kv_bytes_per_token=200_000)
        pools = ns.dis.PoolConfig(n_prefill=2, n_decode=3, decode_batch=4)
        dis = _sim_reqs(ns.api, 21)
        col = _sim_reqs(ns.api, 21)
        out = (ns.dis.simulate_disaggregated(dis, cost, pools,
                                             predict_len=predict_len),
               ns.dis.simulate_colocated(col, cost, 3, decode_batch=4),
               ns.dis.goodput(dis, 0.05, 0.002),
               ns.dis.goodput(col, 0.05, 0.002))
        times = [(r.first_token_time, r.finish_time) for r in dis + col]
        return out, times

    ref, port = run(REF), run(PORT)
    assert port[0][0]["finished"] == 12 == port[0][1]["finished"]
    assert port == ref
    assert tapi.PoolConfig is tdis.PoolConfig
    assert tapi.goodput is tdis.goodput
