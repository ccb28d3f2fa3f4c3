"""The comparison that decides ``correct``, driven through whole runs of
the harness on the CPU (the port's smoke configurations at float32, the
kernels' plain versions; the harness's look for a chip is skipped):

- sound runs are correct;
- the control, the reference in fp8 put in the program's place, is not;
- with the timed path broken underneath, ``correct`` comes out false, once
  for each fault a serving cell can have: a token altered where it is
  produced, a decode step that returns its state (the KV cache)
  unchanged, half of the batch left out (the first half's rows given
  the second half's logits). No cell runs across chips, so no exchange can be left out.
"""
from __future__ import annotations

import math
import types

import pytest
import torch

import perfbench_testlib as lib
from harness import check
from repro_torch.core.serving import engine as engine_mod
from repro_torch.models.transformer import Model

CELLS = ["tiny-qwen-open", "tiny-dsv3-closed"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell):
    out = lib.cpu_run(cell, seed=2**31 + 7)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert len(out["checks"]) >= 2 and "failed_requests" in out["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_fp8_control_is_not_correct(cell, seed):
    out = lib.cpu_run(cell, seed=seed, control=True)
    assert out["failed"] == 0 and out["attempted"] > 0
    assert not out["correct"], out["checks"]
    # failed on a reading of the control, not for want of one
    assert any(math.isfinite(c["value"]) and c["value"] > c["limit"]
               for c in out["checks"].values()), out["checks"]


def test_control_readings_take_the_programs_place(monkeypatch):
    readings = {"gap_max": 0.01, "logit_err_max": 0.01,
                "control_gap_max": 0.02, "control_logit_err_max": 0.5}
    monkeypatch.setattr(check, "sample",
                        lambda run: [{"generated": [1, 2]}])
    monkeypatch.setattr(check, "gaps",
                        lambda run, recs, control=False: dict(readings))
    run = types.SimpleNamespace(
        cell={"check": {"limits": {"gap_max": 0.25,
                                   "logit_err_max": 0.03}}},
        failed=lambda: [])
    ok, out, extra = check.check(run)
    assert ok and out["logit_err_max"]["value"] == 0.01
    ok, out, extra = check.check(run, control=True)
    assert not ok
    assert out["logit_err_max"] == {"value": 0.5, "limit": 0.03}
    assert out["gap_max"] == {"value": 0.02, "limit": 0.25}
    assert extra["logit_err_max"] == 0.01


def test_kept_logits_are_device_copies_of_the_decoding_rows():
    from harness import probe
    logits = torch.arange(4 * 3, dtype=torch.float32).view(4, 3)
    state = types.SimpleNamespace(name="DECODE")
    reqs = [types.SimpleNamespace(rid=7, generated=[1], state=state),
            None,
            types.SimpleNamespace(rid=8, generated=[1, 2, 3], state=state),
            types.SimpleNamespace(rid=9, generated=[], state=state)]
    model = types.SimpleNamespace(prefill=None,
                                  decode_step=lambda *a: (logits, None))
    engine = types.SimpleNamespace(model=model, slot_req=reqs)
    run = types.SimpleNamespace(logits={}, capture_s=0.0, capture_calls=0,
                                in_window=lambda t: True)
    probe.capture_logits(run, engine, rows=2)
    engine.model.decode_step()
    assert sorted(run.logits) == [(7, 1), (9, 0)]
    assert torch.equal(run.logits[(7, 1)], logits[0].to(torch.bfloat16))
    assert run.logits[(9, 0)].data_ptr() != logits[3].data_ptr()
    assert run.capture_calls == 1 and run.capture_s > 0


def _altered_token(monkeypatch):
    orig = engine_mod.sample_token

    def sample_token(*a, **kw):
        tok = orig(*a, **kw)
        return (tok + 1) % 512
    monkeypatch.setattr(engine_mod, "sample_token", sample_token)


def _state_unchanged(monkeypatch):
    orig = Model.decode_step

    def decode_step(self, params, cache, *a, **kw):
        copy = {k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in _flat(cache)}
        logits, _ = orig(self, params, _unflat(copy), *a, **kw)
        return logits, cache
    monkeypatch.setattr(Model, "decode_step", decode_step)


def _half_batch(monkeypatch):
    orig = Model.decode_step

    def decode_step(self, *a, **kw):
        logits, cache = orig(self, *a, **kw)
        half = logits.shape[0] // 2
        return torch.cat([logits[half:2 * half], logits[half:]]), cache
    monkeypatch.setattr(Model, "decode_step", decode_step)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch],
                         ids=["altered_token", "state_unchanged",
                              "half_batch"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = lib.cpu_run(cell, seed=2**31 + 7)
    assert not out["correct"], out["checks"]
