"""The port's SLO-adaptive controller and Pareto sweep
(``repro_torch.control``) against the JAX reference (``repro.control``),
float32 qwen2-vl smoke on the CPU.

Same weights through the bridge, same requests (made from numpy seeds)
through both packages. The contracts of ``tests/test_control.py`` are
held on the port:

  * ZERO policy calls when off: every ``Controller`` and
    ``AdaptivePolicy`` method patched to raise, sync, async and cluster
    serves with ``control=None`` trip none;
  * an attached but unpressured controller is bit-identical at
    temperature 0;
  * no oscillation within the cooldown and no deadlock when deferred
    needs shrink (hypothesis properties, through the shim);
  * the exact revert cycle, and ``commit`` consuming the override;
  * the video routing bias under pressure;
  * the ``control_burst`` scenario of ``benchmarks/bench_serving.py``
    (defer-only and adaptive): tokens, records and ``summary()`` equal
    the reference's, and adaptive beats defer-only on end-to-end SLO
    attainment;
  * the ``repro_control_*`` families, standalone and fleet-wide, with
    the reference's Prometheus text;
  * frontier math, and a 2-point sweep whose records and frontier equal
    the reference's.

The reference's ``test_committed_pareto_baseline_gates`` checks the
committed ``BENCH_pareto.json`` through ``repro.obs.regress``, the
benchmark gate the port does not have yet; it has no counterpart here.
"""
import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
import repro.api as japi
import repro.control as jcontrol
from repro.training.checkpoint import _flatten
import repro_torch.api as tapi
import repro_torch.control as tcontrol
from repro_torch.api import (AdaptivePolicy, AdmissionConfig, ControlConfig,
                             Controller, GenerationConfig)
from repro_torch.control import (DEFAULT_LADDER, LevelState, SweepConfig,
                                 dominates, pareto_frontier, point_key)
from repro_torch.control.controller import _ACTUATION_KINDS
from repro_torch.models.convert import params_from_flat
from repro_torch.obs import NULL_PROFILER, NULL_TRACER
from repro_torch.serving.admission import AdmissionController

MAX_NEW = 6
REF = SimpleNamespace(api=japi, control=jcontrol)
PORT = SimpleNamespace(api=tapi, control=tcontrol)


@pytest.fixture(scope="module")
def pair():
    """(reference LVLM, port LVLM) with the same qwen2-vl smoke weights."""
    j = japi.LVLM.from_pretrained("qwen2-vl-2b", smoke=True)
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    t = tapi.LVLM.from_pretrained("qwen2-vl-2b", smoke=True, device="cpu")
    return j, t.with_params(params_from_flat(flat, "cpu"))


def _both(pair, scenario):
    """Run ``scenario(ns, lvlm)`` on the reference, then on the port."""
    return scenario(REF, pair[0]), scenario(PORT, pair[1])


def _gen(api, **kw):
    base = dict(decoder="greedy", temperature=0.0, max_new_tokens=MAX_NEW)
    base.update(kw)
    return api.GenerationConfig(**base)


def _ec(api, **kw):
    base = dict(max_batch=4, cache_len=128, temperature=0.0, sanitize=True)
    base.update(kw)
    return api.EngineConfig(**base)


def _reqs(api, cfg, n, seed=0, lo=8, hi=16, new=MAX_NEW, visual=True):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        toks = list(rng.randint(1, cfg.vocab_size,
                                size=rng.randint(lo, hi)))
        ve = None
        if visual:
            ve = rng.randn(cfg.num_visual_tokens, cfg.d_model).astype(
                np.float32) * 0.02
        reqs.append(api.Request(rid=i, tokens=toks, max_new_tokens=new,
                                visual_embeds=ve))
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


def _records(server):
    return [dataclasses.asdict(r) for r in server.metrics.records]


# ----------------------------------------------- zero policy calls off --


def test_control_off_makes_zero_policy_calls(pair, monkeypatch):
    t = pair[1]

    def boom(*a, **k):
        raise AssertionError("controller/policy call on the control=None "
                             "path")

    for name in ("attach", "on_step", "shape", "shape_sync", "commit",
                 "revert", "route_bias", "summary", "prom_families"):
        monkeypatch.setattr(Controller, name, boom)
    for name in ("pressure", "update", "overrides_for"):
        monkeypatch.setattr(AdaptivePolicy, name, boom)
    res = t.serve(_reqs(tapi, t.cfg, 3, seed=1), engine_cfg=_ec(tapi),
                  gen=_gen(tapi))
    assert res.stats["finished"] == 3
    got = _drive_all(t.serve_async(_ec(tapi), gen=_gen(tapi)),
                     _reqs(tapi, t.cfg, 3, seed=2))
    assert all(len(o) == MAX_NEW for o in got.values())
    router = t.serve_cluster(2, _ec(tapi), gen=_gen(tapi))
    got = _drive_all(router, _reqs(tapi, t.cfg, 4, seed=3))
    assert all(len(o) == MAX_NEW for o in got.values())
    router.metrics_snapshot()
    router.summary()


def test_unpressured_controller_is_bit_identical_at_temp0(pair):
    def scenario(ns, lvlm):
        api = ns.api
        ref = _drive_all(lvlm.serve_async(_ec(api), gen=_gen(api)),
                         _reqs(api, lvlm.cfg, 4, seed=5))
        ctl = ns.control.Controller()
        got = _drive_all(lvlm.serve_async(_ec(api), gen=_gen(api),
                                          control=ctl),
                         _reqs(api, lvlm.cfg, 4, seed=5))
        assert got == ref
        return got, ctl.fleet_level, ctl.summary()

    ref, port = _both(pair, scenario)
    _, level, s = port
    assert level == 0 and s["control_overrides_open"] == 0
    assert sum(v for k, v in s.items()
               if k.startswith("control_actuations/")) == 0
    assert port == ref


def test_closed_loop_control_shapes_at_submit_as_reference(pair):
    """``serve(control=)``: each request is shaped at submit against the
    KV already committed; tokens, stats and the controller's counters
    equal the reference's."""
    def scenario(ns, lvlm):
        api = ns.api
        ctl = ns.control.Controller(ns.control.ControlConfig(cooldown_s=0.0))
        res = lvlm.serve(_reqs(api, lvlm.cfg, 6, seed=21, new=4),
                         engine_cfg=_ec(api, max_batch=6, cache_len=256,
                                        kv_capacity_tokens=128),
                         gen=_gen(api, max_new_tokens=4), control=ctl)
        return ({r.rid: (list(r.generated), r.compression)
                 for r in res.requests}, res.stats, ctl.summary())

    ref, port = _both(pair, scenario)
    comps = [c for _, c in port[0].values()]
    assert port[2]["control_commits"] > 0 and "fastv-0.5" in comps
    assert port == ref


# ----------------------------------------------- no-thrash (property) --


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=2.0),
                min_size=2, max_size=60),
       st.floats(min_value=0.001, max_value=0.1))
def test_no_level_oscillation_within_cooldown(pressures, cooldown):
    """Any pressure trace: level changes at least ``cooldown_s`` apart,
    one rung each, inside the ladder, and the reference's policy walks
    the same levels."""
    policy = AdaptivePolicy(ControlConfig(cooldown_s=cooldown))
    jpolicy = jcontrol.AdaptivePolicy(jcontrol.ControlConfig(
        cooldown_s=cooldown))
    state, jstate = LevelState(), jcontrol.LevelState()
    clock, last_change_at = 0.0, None
    prev = 0
    for p in pressures:
        clock += cooldown / 3.0
        level = policy.update(state, p, clock)
        assert level == jpolicy.update(jstate, p, clock)
        assert 0 <= level < len(DEFAULT_LADDER)
        assert abs(level - prev) <= 1
        if level != prev:
            if last_change_at is not None:
                assert clock - last_change_at >= cooldown - 1e-12
            last_change_at = clock
        prev = level


def test_hysteresis_band_is_inert():
    policy = AdaptivePolicy(ControlConfig(cooldown_s=0.0))
    state = LevelState()
    for i in range(20):
        assert policy.update(state, 0.7, float(i)) == 0
    policy.update(state, 0.9, 100.0)
    assert state.level == 1
    for i in range(20):
        assert policy.update(state, 0.7, 200.0 + i) == 1


def test_ladder_and_config_equal_reference():
    assert [dataclasses.asdict(r) for r in DEFAULT_LADDER] == [
        dataclasses.asdict(r) for r in jcontrol.DEFAULT_LADDER]
    assert dataclasses.asdict(ControlConfig()) == dataclasses.asdict(
        jcontrol.ControlConfig())
    with pytest.raises(ValueError, match="rung 0"):
        ControlConfig(ladder=(DEFAULT_LADDER[1],))
    with pytest.raises(ValueError, match="low_pressure"):
        ControlConfig(low_pressure=0.9, high_pressure=0.8)
    with pytest.raises(TypeError, match="control="):
        Controller("aggressive")


# ------------------------------------------- no-deadlock (property) --


class _FakeEngine:
    """Duck-typed engine for AdmissionController: KV accounting only;
    ``kv_request_tokens`` reads the request's live ``need``."""

    def __init__(self, capacity):
        self.kv_capacity_tokens = capacity
        self.waiting, self.running = [], []
        self.clock = 0.0

    def kv_committed_tokens(self):
        return sum(r.need for r in self.running)

    def kv_request_tokens(self, req):
        return req.need

    def submit(self, req):
        self.running.append(req)

    def retire(self, req):
        self.running.remove(req)


class _FakeReq:
    def __init__(self, rid, need):
        self.rid, self.need = rid, need
        self.compression, self.decoder = None, None


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=64, max_value=256),
       st.lists(st.integers(min_value=8, max_value=200),
                min_size=1, max_size=12),
       st.integers(min_value=2, max_value=8))
def test_shrinking_deferred_need_never_deadlocks(capacity, needs, shrink):
    async def run():
        eng = _FakeEngine(capacity)
        adm = AdmissionController(
            AdmissionConfig(high_watermark=0.9, low_watermark=0.7), eng)
        reqs = [_FakeReq(i, min(n, capacity)) for i, n in enumerate(needs)]
        tasks = [asyncio.ensure_future(adm.admit(r)) for r in reqs]
        for _ in range(4):
            await asyncio.sleep(0)
        for _ in range(10 * len(reqs) + 10):
            if all(t.done() for t in tasks):
                break
            for entry in list(adm._waiters):
                req = entry[1]
                req.need = max(1, req.need // shrink)
                assert adm.refresh(req)
            adm.maybe_admit()
            if eng.running:
                eng.retire(eng.running[0])
            adm.maybe_admit()
            await asyncio.sleep(0)
        assert all(t.done() for t in tasks), "admission deadlocked"
        assert all(t.result() is True for t in tasks)

    asyncio.run(run())


# --------------------------------------------------- override lifecycle --


class _FakeSpecDecoder:
    def __init__(self):
        self.gamma = 4


class _FakeExitDecoder:
    def __init__(self):
        self.threshold = 0.8


class _KnobEngine(_FakeEngine):
    def __init__(self, capacity):
        super().__init__(capacity)
        self.trace_replica = 0
        self._default_name = "greedy"
        self._decoders = {"speculative": _FakeSpecDecoder(),
                          "early_exit": _FakeExitDecoder()}
        self.committed = 0

    def kv_committed_tokens(self):
        return self.committed

    def kv_request_tokens(self, req):
        need = req.need
        if req.compression == "fastv-0.5":
            need //= 2
        elif req.compression == "fastv-0.25":
            need //= 4
        return max(1, need)


class _FakeServer:
    def __init__(self, capacity=1000):
        self.engine = _KnobEngine(capacity)
        self.admission = AdmissionController(
            AdmissionConfig(high_watermark=0.9, low_watermark=0.3),
            self.engine)
        self.tracer = NULL_TRACER
        self.profiler = NULL_PROFILER


def test_pressure_cycle_reverts_deferred_overrides_exactly():
    async def run():
        srv = _FakeServer()
        eng = srv.engine
        ctl = Controller(ControlConfig(cooldown_s=0.0))
        ctl.attach(srv)
        reqs = [_FakeReq(0, 64), _FakeReq(1, 64)]
        reqs[1].decoder = "speculative"
        loop = asyncio.get_running_loop()
        for r in reqs:
            srv.admission._waiters.append(
                (loop.create_future(), r, eng.kv_request_tokens(r),
                 eng.submit))

        eng.committed = 900
        ctl.on_step(srv)
        assert ctl.level(srv) == 1
        assert all(r.compression == "fastv-0.5" for r in reqs)
        assert eng._decoders["speculative"].gamma == 2
        ctl.on_step(srv)
        assert ctl.level(srv) == 2
        assert all(r.compression == "fastv-0.25" for r in reqs)
        assert reqs[1].decoder == "greedy"
        assert eng._decoders["speculative"].gamma == 1
        assert eng._decoders["early_exit"].threshold \
            == pytest.approx(0.8 * 0.8)
        assert ctl.summary()["control_overrides_open"] == 2

        eng.committed = 400
        ctl.on_step(srv)
        assert all(r.compression == "fastv-0.5" for r in reqs)
        ctl.on_step(srv)
        assert ctl.level(srv) == 0
        assert reqs[0].compression is None and reqs[0].decoder is None
        assert reqs[1].compression is None
        assert reqs[1].decoder == "speculative"
        assert eng._decoders["speculative"].gamma == 4
        assert eng._decoders["early_exit"].threshold == pytest.approx(0.8)
        s = ctl.summary()
        assert s["control_overrides_open"] == 0
        assert s["control_reverts"] >= 2
        for fut, *_ in srv.admission._waiters:
            fut.cancel()

    asyncio.run(run())


def test_commit_consumes_override_and_revert_is_then_a_noop():
    srv = _FakeServer()
    ctl = Controller(ControlConfig(cooldown_s=0.0))
    ctl.attach(srv)
    ctl._state[id(srv)].level = 1
    req = _FakeReq(7, 32)
    assert ctl.shape(srv, req)
    assert req.compression == "fastv-0.5"
    assert ctl.commit(req)
    assert ctl.summary()["control_overrides_open"] == 0
    assert not ctl.revert(req)
    assert req.compression == "fastv-0.5"


def test_route_bias_prefers_aggressive_replicas_under_pressure(pair):
    t = pair[1]

    class _Rep:
        def __init__(self, server):
            self.server = server

    ctl = Controller(ControlConfig(cooldown_s=0.0))
    plain = _Rep(t.serve_async(_ec(tapi), gen=_gen(tapi)))
    aggressive = _Rep(t.serve_async(
        _ec(tapi), gen=GenerationConfig(decoder="greedy", temperature=0.0,
                                        max_new_tokens=MAX_NEW,
                                        compression="fastv-0.25")))
    ctl.attach(plain.server)
    video = _reqs(tapi, t.cfg, 1, seed=9)[0]
    text = _reqs(tapi, t.cfg, 1, seed=9, visual=False)[0]
    cands = [plain, aggressive]
    assert ctl.route_bias(video, cands) == cands
    ctl._state[id(plain.server)].level = 1
    assert ctl.route_bias(video, cands) == [aggressive]
    assert ctl.route_bias(text, cands) == cands
    assert ctl.actuations["route"] == 1


# ------------------------------------------------- burst acceptance --


def test_control_burst_equals_reference_and_beats_defer_only(pair):
    """``bench_serving.control_burst`` at smoke size: a video-heavy
    Poisson burst into a KV-tight server, defer-only and adaptive. The
    port's tokens, records and summaries equal the reference's; the
    controller strictly beats defer-only on end-to-end SLO attainment
    and leaves no override open (sanitizer on throughout)."""
    def scenario(ns, lvlm):
        api = ns.api

        def workload():
            rng = np.random.RandomState(77)
            reqs = _reqs(api, lvlm.cfg, 16, seed=78, lo=8, hi=14, new=8,
                         visual=False)
            arrivals = np.cumsum(rng.exponential(1 / 4000.0,
                                                 size=len(reqs)))
            for i, r in enumerate(reqs):
                r.arrival = float(arrivals[i])
                r.slo = api.SLO(ttft_ms=30.0, tpot_ms=6.0)
                r.visual_embeds = rng.randn(
                    160, lvlm.cfg.d_model).astype(np.float32) * 0.02
            return reqs

        out = {}
        for label, ctl in (("defer_only", None),
                           ("adaptive",
                            ns.control.ControlConfig(cooldown_s=0.001))):
            server = lvlm.serve_async(
                _ec(api, max_batch=8, cache_len=256, kv_capacity_tokens=512),
                gen=api.GenerationConfig(decoder="greedy", temperature=0.0,
                                         max_new_tokens=8),
                admission=api.AdmissionConfig(high_watermark=0.9,
                                              low_watermark=0.7),
                control=ctl)
            got = _drive_all(server, workload())
            out[label] = (got, _records(server), server.summary())
        return out

    ref, port = _both(pair, scenario)
    off, on = port["defer_only"][2], port["adaptive"][2]
    assert off["finished"] == on["finished"] == 16
    assert off["deferred"] > 0
    assert on["slo_e2e_attainment"] > off["slo_e2e_attainment"]
    assert on["control_commits"] > 0 and on["control_overrides_open"] == 0
    for s in (off, on):
        assert s["slo_e2e_attainment"] <= s["slo_ttft_attainment"] + 1e-9
    assert port == ref


# ------------------------------------------------------- observability --


def test_control_metrics_families_and_summary_keys(pair):
    """The ``repro_control_*`` families and ``control_*`` summary keys,
    standalone and once per fleet, with the reference's text."""
    def scenario(ns, lvlm):
        api = ns.api
        server = lvlm.serve_async(_ec(api), gen=_gen(api), control=True)
        _drive_all(server, _reqs(api, lvlm.cfg, 3, seed=11))
        router = lvlm.serve_cluster(2, _ec(api), gen=_gen(api),
                                    control=True)
        _drive_all(router, _reqs(api, lvlm.cfg, 4, seed=12))
        return (server.metrics_snapshot(), server.summary(),
                router.metrics_snapshot(), router.summary())

    ref, port = _both(pair, scenario)
    text, s, fleet_text, fleet_s = port
    for family in ("repro_admission_draining", "repro_control_level",
                   "repro_control_actuations_total",
                   "repro_control_commits_total",
                   "repro_control_overrides_open"):
        assert family in text, family
    for kind in _ACTUATION_KINDS:
        assert f'kind="{kind}"' in text
    for key in ("control_level", "control_commits", "control_reverts",
                "control_level_changes", "control_overrides_open"):
        assert key in s, key
    assert fleet_text.count("# TYPE repro_control_level gauge") == 1
    assert 'repro_control_level{replica="0"}' in fleet_text
    assert 'repro_control_level{replica="1"}' in fleet_text
    assert "control_level" in fleet_s
    assert port == ref


def test_defer_only_snapshot_has_no_control_families(pair):
    t = pair[1]
    server = t.serve_async(_ec(tapi), gen=_gen(tapi))
    _drive_all(server, _reqs(tapi, t.cfg, 2, seed=13))
    text = server.metrics_snapshot()
    assert "repro_control_" not in text
    assert "repro_admission_draining" in text
    assert "control_level" not in server.summary()


# ------------------------------------------------------ sweep harness --


def _pt(key, quality, goodput, ttft, tpot):
    return {"key": key, "quality_proxy": quality, "slo_goodput": goodput,
            "ttft_p95_s": ttft, "tpot_p95_s": tpot}


def test_dominates_and_frontier_on_hand_built_points():
    a = _pt("a", 1.0, 1.0, 0.010, 0.002)
    b = _pt("b", 0.5, 0.9, 0.005, 0.001)
    c = _pt("c", 0.5, 0.8, 0.012, 0.003)
    d = _pt("d", 1.0, 1.0, 0.010, 0.002)
    e = {"key": "e", "quality_proxy": 0.4, "slo_goodput": 0.5,
         "ttft_p95_s": 0.02}
    pts = [a, b, c, d, e]
    assert dominates(a, c) and dominates(b, c)
    assert not dominates(a, b) and not dominates(b, a)
    assert not dominates(a, d) and not dominates(d, a)
    assert not dominates(e, c) and dominates(b, e)
    assert {p["key"] for p in pareto_frontier(pts)} == {"a", "b", "d"}
    for p in pts:
        for q in pts:
            assert dominates(p, q) == jcontrol.dominates(p, q)
    assert pareto_frontier(pts) == jcontrol.pareto_frontier(pts)


def test_point_key_and_sweep_config_grid():
    cfg = SweepConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jcontrol.SweepConfig())
    n_grid = (len(cfg.presets) * len(cfg.decoders) * len(cfg.mixes)
              * len(cfg.rates))
    assert n_grid >= 8
    pt = {"compression": "fastv-0.5", "decoder": "greedy", "mix": "2x",
          "rate_rps": 800.0}
    assert point_key(pt) == "fastv-0.5|greedy|2x|r800"


def test_two_point_sweep_equals_reference(monkeypatch):
    """A 2-point grid (two presets, greedy, the 2x mix, one rate) through
    ``run_sweep``: every record and the frontier equal the reference's.
    Each package builds its own smoke model from its own seed: greedy
    records on the virtual clock do not depend on the weights."""
    def cfg(ns):
        return ns.control.SweepConfig(presets=("none", "fastv-0.5"),
                                      decoders=("greedy",), mixes=("2x",),
                                      rates=(800.0,), n_requests=4,
                                      max_new_tokens=3)

    ref = jcontrol.run_sweep(cfg(REF))
    port = tcontrol.run_sweep(cfg(PORT), device="cpu")
    assert len(port["points"]) == 2 and port["frontier"]
    assert port == ref


def test_sweep_cli_needs_an_out_path(tmp_path, capsys):
    """The port's sweep CLI writes only where ``--out`` says."""
    from repro_torch.control import sweep
    with pytest.raises(SystemExit):
        sweep.main(["--device", "cpu"])
    assert "--out" in capsys.readouterr().err
