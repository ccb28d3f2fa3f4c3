"""The readers of the program's own recorders (``harness.sites`` and the
five metrics over it) on synthetic sites and events, the idle stretches
cut at site edges, and one CPU run of a fixture cell with the recorders
on (``record.py``)."""
from __future__ import annotations

import json
import math
import time

import numpy as np
import pytest

import perfbench_testlib as lib
from harness import sites, spec
from harness.devtrace import DeviceTrace
from harness.serve import Run

READERS = ["engine.step_ms_p95", "engine.queue_ms_p50",
           "engine.first_token_hold_ms_p50", "engine.decode_live_pct",
           "moe.decode_buffer_fill_pct"]


def recorders():
    """A profiler and a tracer on one manual clock (seconds), the
    profiler's epoch equal to the clock in nanoseconds."""
    from repro_torch.obs import Profiler, Tracer
    t = [0.0]
    prof = Profiler(clock=lambda: t[0])
    prof.anchor_epoch_ns, prof.anchor_clock = 0, 0.0
    return prof, Tracer(clock=lambda: t[0]), t


def site(prof, t, name, t0, t1, children=(), **attrs):
    t[0] = t0
    prof.site_begin(name)
    for c in children:
        site(prof, t, *c[:3], children=c[3] if len(c) > 3 else (),
             **(c[4] if len(c) > 4 else {}))
    t[0] = t1
    prof.site_end(name, **attrs)


def span(tracer, t, when, kind, name, rid):
    t[0] = when
    (tracer.span_begin if kind == "B" else tracer.span_end)(name, rid)


def synthetic_run():
    """Window [10, 20): three steps in it and one before; two decodes
    (3 and 1 live rows of 4) with their expert layers, an expert layer in
    a prefill; requests 1 and 2 queued 250 and 100 ms and held 50 and
    300 ms, request 3 never prefilled."""
    prof, tracer, t = recorders()
    site(prof, t, "engine.step", 9.0, 9.1, [
        ("model.decode", 9.0, 9.05, [], {"rows_live": 4,
                                        "rows_launched": 4})])
    site(prof, t, "engine.step", 10.0, 10.2, [
        ("model.decode", 10.0, 10.15, [
            ("model.attn", 10.0, 10.05),
            ("model.moe", 10.05, 10.1, (), {"pairs": 6, "buffer_rows": 28}),
            ("model.moe", 10.1, 10.15, (), {"pairs": 6,
                                             "buffer_rows": 28})],
         {"rows_live": 3, "rows_launched": 4})])
    span(tracer, t, 10.05, "B", "request", 1)
    span(tracer, t, 10.3, "B", "prefill", 1)
    site(prof, t, "engine.step", 10.3, 10.4, [
        ("model.prefill", 10.3, 10.33, [
            ("model.moe", 10.31, 10.32, (), {"pairs": 40,
                                              "buffer_rows": 44})]),
        ("model.decode", 10.34, 10.345, [
            ("model.moe", 10.34, 10.345, (), {"pairs": 2,
                                               "buffer_rows": 12})],
         {"rows_live": 1, "rows_launched": 4})])
    span(tracer, t, 10.35, "E", "prefill", 1)
    span(tracer, t, 10.9, "B", "request", 2)
    span(tracer, t, 11.0, "B", "prefill", 2)
    span(tracer, t, 11.2, "E", "prefill", 2)
    site(prof, t, "engine.step", 11.0, 11.5)
    span(tracer, t, 12.0, "B", "request", 3)
    run = Run.__new__(Run)
    run.ws, run.we = 10.0, 20.0
    run.records = [{"rid": r, "due": d, "failed": None}
                   for r, d in ((0, 9.0), (1, 10.0), (2, 10.8), (3, 12.0))]
    run.profiler, run.tracer = prof, tracer
    return run


def read(run, metric):
    return spec.metric_reader(metric)(run)


def test_step_wall_p95_over_the_windows_steps():
    run = synthetic_run()
    assert read(run, "engine.step_ms_p95") == \
        pytest.approx(float(np.percentile([200.0, 100.0, 500.0], 95)))


def test_queue_median_from_submit_to_prefill():
    run = synthetic_run()
    assert sites.queue_ms(run) == pytest.approx([250.0, 100.0, math.inf])
    assert read(run, "engine.queue_ms_p50") == pytest.approx(250.0)


def test_first_token_hold_to_the_end_of_its_step():
    run = synthetic_run()
    assert sites.first_token_hold_ms(run) == \
        pytest.approx([50.0, 300.0, math.inf])
    assert read(run, "engine.first_token_hold_ms_p50") == \
        pytest.approx(300.0)


def test_decode_live_share_of_launched_rows():
    assert read(synthetic_run(), "engine.decode_live_pct") == \
        pytest.approx(100.0 * 4 / 8)


def test_expert_buffer_fill_inside_the_windows_decodes():
    assert read(synthetic_run(), "moe.decode_buffer_fill_pct") == \
        pytest.approx(100.0 * 14 / 68)


@pytest.mark.parametrize("metric", READERS)
def test_readers_return_nothing_without_the_recorders(metric):
    """The harness's own runs keep no recorder: every reader is silent."""
    run = synthetic_run()
    del run.profiler, run.tracer
    assert read(run, metric) is None


def test_innermost_site_pieces():
    mk = [{"name": n, "t0_ns": a, "t1_ns": b}
          for n, a, b in (("engine.step", 10, 50), ("model.decode", 12, 30),
                          ("model.attn", 12, 20), ("engine.sample", 30, 40),
                          ("server.fan_out", 55, 60))]
    assert sites.innermost(mk, 0, 70) == [
        (0, 10, "between steps"), (10, 12, "engine.step"),
        (12, 20, "model.attn"), (20, 30, "model.decode"),
        (30, 40, "engine.sample"), (40, 50, "engine.step"),
        (50, 55, "between steps"), (55, 60, "server.fan_out"),
        (60, 70, "between steps")]
    assert sites.innermost(mk, 15, 35) == [
        (15, 20, "model.attn"), (20, 30, "model.decode"),
        (30, 35, "engine.sample")]


def test_idle_by_site_cuts_the_idle_gaps_at_site_edges():
    """The device is busy over [0, 12 us) and [40, 45 us) of a 100 us
    stretch; the idle stretches the gaps take, named by the innermost
    site, sum to the gaps' total."""
    us = 1000
    ops = [("k", 0, 12 * us), ("k", 40 * us, 45 * us)]
    dt = DeviceTrace(ops, [], 0, 100 * us)
    mk = [{"name": n, "t0_ns": a * us, "t1_ns": b * us}
          for n, a, b in (("engine.step", 5, 70), ("model.decode", 5, 35),
                          ("engine.sample", 35, 70),
                          ("server.fan_out", 75, 80))]
    got = dict(sites.idle_by_site(dt, mk, min_ns=1))
    assert got == pytest.approx({
        "model.decode": 23e-6, "engine.sample": 30e-6,
        "between steps": 25e-6, "server.fan_out": 5e-6})
    assert sum(got.values()) == pytest.approx(
        sum(v for _, v in dt.idle_gaps(min_ns=1)))


def test_idle_share_over_sites_is_the_harness_share():
    us = 1000
    ops = [("k", 0, 12 * us), ("k", 40 * us, 45 * us), ("k", 60 * us,
                                                         90 * us)]
    steps = [(5 * us, 50 * us), (55 * us, 95 * us)]
    dt = DeviceTrace(ops, [("engine_step", a, b) for a, b in steps], 0,
                     100 * us)
    mk = [{"name": "engine.step", "t0_ns": a, "t1_ns": b} for a, b in steps]
    assert sites.idle_share_in_sites(dt, mk) == \
        pytest.approx(dt.idle_share_in_steps())


def test_a_recorded_cpu_run_reads_every_metric(tmp_path):
    """A fixture cell's traced run with the recorders on: the five metrics
    are read, the live rows agree with the harness's own count, and with
    the profiler taken away none is."""
    import harness.serve as hs
    import record
    import run as bench

    cell = "tiny-dsv3-closed"
    bj = record.bench_json(tmp_path / "bench.json",
                           lib.FIXTURES / "BENCHMARK.json", cells=[cell],
                           moe_cells=[cell])
    names = [m["name"] for m in json.loads(bj.read_text())["per_layer"]]
    assert names[-5:] == READERS
    base = hs.Run
    cls = record.recorded_run(True, base)
    try:
        hs.Run = cls
        out = bench.run_cell(cell, 5, 0.6, True, "cpu", data_dir=lib.FIXTURES,
                             bench_json=bj, t_start=time.perf_counter())
    finally:
        hs.Run = base
    run = cls.made.pop()
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] and set(READERS) <= set(m)
    live = m["engine.decode_live_pct"] * run.ec.max_batch / 100
    assert live == pytest.approx(m["engine.decode_batch_mean"])
    assert 0 < m["moe.decode_buffer_fill_pct"] <= 100
    assert m["engine.step_ms_p95"] > 0 and m["engine.queue_ms_p50"] >= 0
    assert 0 <= m["engine.first_token_hold_ms_p50"] < math.inf
    assert len(run.step_walls) >= len(sites.window_sites(run, "engine.step"))
    got = record.checks(run, out)
    assert got["live_rows"][0] == pytest.approx(got["live_rows"][1])
    assert got["recorder_us"]["sites_per_step"] > 1
    assert 0 < got["recorder_us"]["ms_per_step"] < max(run.step_walls) * 1e3
    del run.profiler
    assert all(spec.metric_reader(r)(run) is None for r in READERS)
