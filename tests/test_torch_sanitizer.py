"""The port's runtime sanitizer (``repro_torch.analysis.sanitizer``).

  * the conservation checks of ``tests/test_analysis.py`` on a fake engine
    and server, each finding what the reference's checker finds on the
    same state (the same problem strings);
  * on the port's real engine: a draft row whose release is dropped, a
    prefix pin counted twice and a slot left bound to a retired request
    are each a ``SanitizerError`` at the next boundary;
  * the property-based invariants of ``tests/test_engine_invariants.py``
    on the port's engine with ``sanitize=True`` (every step and abort
    boundary checked), through ``tests/_hypothesis_compat``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

import repro.analysis.sanitizer as jsan
from repro.core.serving.request import State as JState
from repro_torch.analysis import sanitizer as tsan
from repro_torch.api.decoders import SpeculativeDecoder
from repro_torch.configs import get_config
from repro_torch.core.serving import Engine, EngineConfig, Request
from repro_torch.core.serving.request import State
from repro_torch.models.registry import build


# ----------------------------------------------------- fake-engine checks --

def _fake_engine(state_cls, n_slots=2, cache_len=32):
    req = SimpleNamespace(rid=7, state=state_cls.DECODE, _slot=0,
                          _prefix_pin=None)
    eng = SimpleNamespace(
        running=[req], waiting=[], slot_req=[req] + [None] * (n_slots - 1),
        slot_pos=[4] + [0] * (n_slots - 1),
        ec=SimpleNamespace(cache_len=cache_len),
        _decoders={}, _prefix_pins={}, _prefix={},
        kv_committed_tokens=lambda include_waiting=True: 4,
        kv_request_tokens=lambda r: 4)
    return eng, req


def _tamper_none(eng, req, state_cls):
    pass


def _tamper_kv_drift(eng, req, state_cls):
    eng.kv_committed_tokens = lambda include_waiting=True: 9


def _tamper_done_slot(eng, req, state_cls):
    req.state = state_cls.DONE
    eng.running = []
    eng.kv_committed_tokens = lambda include_waiting=True: 0


def _tamper_draft_row(eng, req, state_cls):
    eng._decoders = {"speculative": SimpleNamespace(
        bound_slots=lambda: {0, 1})}      # slot 1 is free in slot_req


def _tamper_counted_pin(eng, req, state_cls):
    key = ("none", (1, 2, 3))
    eng._prefix_pins = {key: 1}
    eng._prefix = {key: ()}


def _tamper_uncounted_pin(eng, req, state_cls):
    req._prefix_pin = ("none", (1, 2, 3))


def _tamper_position(eng, req, state_cls):
    eng.slot_pos[0] = 32


@pytest.mark.parametrize("tamper,expect", [
    (_tamper_none, None),
    (_tamper_kv_drift, "kv_committed"),
    (_tamper_done_slot, "slot leak"),
    (_tamper_draft_row, "draft-row leak"),
    (_tamper_counted_pin, "pin leak"),
    (_tamper_uncounted_pin, "no longer counts"),
    (_tamper_position, "outside cache_len"),
], ids=["clean", "kv_drift", "done_slot", "draft_row", "counted_pin",
        "uncounted_pin", "position"])
def test_engine_conservation_equals_reference(tamper, expect):
    eng, req = _fake_engine(State)
    tamper(eng, req, State)
    got = tsan.check_engine_conservation(eng)
    jeng, jreq = _fake_engine(JState)
    tamper(jeng, jreq, JState)
    assert got == jsan.check_engine_conservation(jeng)
    if expect is None:
        assert got == []
    else:
        assert any(expect in p for p in got), got


def test_server_conservation_orphan_and_aborted_stream():
    eng, _ = _fake_engine(State)
    server = SimpleNamespace(engine=eng, _streams={})
    assert any("no registered stream" in p
               for p in tsan.check_server_conservation(server))
    server._streams = {7: SimpleNamespace(aborted=False)}
    assert tsan.check_server_conservation(server) == []
    server._streams = {7: SimpleNamespace(aborted=True)}
    assert any("still registered" in p
               for p in tsan.check_server_conservation(server))


def test_sanitize_enabled_reads_the_env(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert tsan.sanitize_enabled() is False
    for val, want in (("1", True), ("on", True), ("0", False)):
        monkeypatch.setenv("REPRO_SANITIZE", val)
        assert tsan.sanitize_enabled() is want
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    model, params = small_model()
    assert Engine(model, params, EngineConfig(max_batch=1)).sanitize
    assert not Engine(model, params, EngineConfig(max_batch=1,
                                                  sanitize=False)).sanitize


# --------------------------------------------------- the real engine --

MAX_BATCH = 3
CACHE_LEN = 48
GAMMA = 2
VOCAB = 32          # tiny vocab so random eos ids actually fire
_MODEL = {}


def small_model():
    if not _MODEL:
        cfg = get_config("phi4-mini-3.8b", smoke=True).with_(
            vocab_size=VOCAB)
        model = build(cfg)
        _MODEL["m"] = (model, model.init(0, "cpu"))
    return _MODEL["m"]


def _engine(**kw):
    model, params = small_model()
    base = dict(max_batch=MAX_BATCH, cache_len=CACHE_LEN, decoder="greedy",
                sanitize=True)
    base.update(kw)
    eng = Engine(model, params, EngineConfig(**base))
    eng._decoders["speculative"] = SpeculativeDecoder(gamma=GAMMA)
    return eng


def test_dropped_draft_row_release_trips(monkeypatch):
    """A speculative request retires but its draft row is never released:
    the next step boundary raises (a draft-pool leak)."""
    monkeypatch.setattr(SpeculativeDecoder, "release_slot",
                        lambda self, slot: None)
    eng = _engine()
    eng.submit(Request(rid=0, tokens=[1, 2, 3], max_new_tokens=2,
                       decoder="speculative"))
    with pytest.raises(tsan.SanitizerError, match="draft-row leak"):
        while eng.step():
            pass


def test_abort_boundary_checks_and_a_stale_slot_trips():
    eng = _engine()
    eng.submit(Request(rid=0, tokens=[1, 2, 3], max_new_tokens=4))
    eng.submit(Request(rid=1, tokens=[4, 5], max_new_tokens=4))
    eng.step()
    assert eng.abort(0)                 # a clean abort passes the check
    stale = eng.slot_req.index(next(r for r in eng.running if r.rid == 1))
    eng.running[0].state = State.DONE   # retired, slot never freed
    eng.running = []
    with pytest.raises(tsan.SanitizerError, match="slot leak"):
        eng._sanitize_check("test")
    assert eng.slot_req[stale] is not None


def test_double_counted_prefix_pin_trips():
    model, params = small_model()
    eng = Engine(model, params, EngineConfig(
        max_batch=1, cache_len=CACHE_LEN, prefix_cache=True, prefix_block=4,
        sanitize=True, decoder="greedy"))
    a = [1, 2, 3, 4, 5, 6, 7, 8]
    eng._prefix_insert(a, 0, 8)
    eng.submit(Request(rid=0, tokens=a + [9], max_new_tokens=3))
    eng.step()                          # prefill hits and pins the entry
    key = ("none", tuple(a))
    assert eng._prefix_pins[key] == 1
    eng._prefix_pins[key] += 1          # a pin nobody will release
    with pytest.raises(tsan.SanitizerError, match="pin leak"):
        eng.step()


# ------------------------------------------- property-based invariants --

REQ = st.tuples(
    st.sampled_from((3, 5, 8)),                          # prompt length
    st.integers(1, 5),                                   # max_new_tokens
    st.floats(0.0, 0.02),                                # arrival
    st.sampled_from((None, "greedy", "sampling",
                     "speculative", "early_exit")),      # per-request decoder
)


def _run_and_check(reqspecs, scheduler, temperature, eos_id, seed,
                   abort_rid=None):
    eng = _engine(scheduler=scheduler, chunk_size=4, token_budget=16,
                  temperature=temperature, eos_id=eos_id, seed=seed)
    rng = np.random.RandomState(seed)
    reqs = []
    for i, (plen, new, arrival, dec) in enumerate(reqspecs):
        reqs.append(Request(
            rid=i, tokens=list(rng.randint(1, VOCAB, size=plen)),
            max_new_tokens=new, arrival=arrival, decoder=dec))
        eng.submit(reqs[-1])
    steps = 0
    while True:
        alive = eng.step()              # sanitizer runs at the boundary
        steps += 1
        assert steps < 2000, "engine failed to drain"
        if steps == 2 and abort_rid is not None:
            eng.abort(abort_rid)        # and at the abort boundary
        active_slots = [r._slot for r in eng.running]
        assert len(active_slots) == len(set(active_slots)), \
            "two running requests share a slot"
        for r in eng.running:
            s = r._slot
            assert eng.slot_req[s] is r, "slot map out of sync"
            assert int(eng.slot_pos[s]) + r.lookahead <= CACHE_LEN - 1, \
                (r.rid, int(eng.slot_pos[s]), r.lookahead)
        if not alive:
            break
    aborted = {r.rid for r in eng.aborted}
    assert len(eng.finished) + len(aborted) == len(reqs)
    rids = [r.rid for r in eng.finished]
    assert sorted(rids + sorted(aborted)) == sorted(r.rid for r in reqs)
    assert len(set(rids)) == len(rids), "double-retire (slot double-free)"
    assert all(sr is None for sr in eng.slot_req), "slot leaked"
    assert eng._decoders["speculative"].bound_slots() == set()
    assert eng.kv_committed_tokens() == 0
    for r in eng.finished:
        assert 1 <= len(r.generated) <= r.max_new_tokens
        assert r.arrival <= r.first_token_time <= r.finish_time, \
            (r.rid, r.arrival, r.first_token_time, r.finish_time)
        if eos_id >= 0:
            assert eos_id not in r.generated[:-1], (r.rid, r.generated)


@settings(max_examples=5, deadline=None, derandomize=True)
@given(reqspecs=st.lists(REQ, min_size=1, max_size=4),
       scheduler=st.sampled_from(("continuous", "chunked", "mlfq",
                                  "static")),
       temperature=st.sampled_from((0.0, 0.7)),
       eos_id=st.sampled_from((-1, 5)),
       seed=st.integers(0, 10_000),
       abort=st.sampled_from((None, 0)))
def test_engine_invariants_random_mixes_sanitized(reqspecs, scheduler,
                                                  temperature, eos_id, seed,
                                                  abort):
    _run_and_check(reqspecs, scheduler, temperature, eos_id, seed,
                   abort_rid=abort)


def test_engine_invariants_all_speculative_eos_sanitized():
    _run_and_check([(5, 5, 0.0, "speculative"),
                    (8, 4, 0.0, "speculative"),
                    (3, 5, 0.001, "speculative")],
                   "continuous", 0.0, 5, 3, abort_rid=1)
