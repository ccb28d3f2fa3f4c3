"""Run a cell with the program's own recorders on: the port's ``Tracer``
and ``Profiler`` passed to ``LVLM.serve_async(obs=, profile=)`` and kept
on the run for ``harness.sites`` and the per-layer metrics that read it.
Not part of a benchmark run: ``run.py`` keeps the recorders off.

    python3 perfbench/record.py --workload dsv3-chat-decode \
        --seeds 11 12 --seconds 50 --trace 1 --record 1

Each run is one ``run.run_cell`` of the cell (the same set-up, window,
drain and check), in this process, one after another; ``--record both``
runs each seed with the recorders off and on, the order turned at every
seed. ``--record toggle`` keeps both recorders but turns the profiler's
sites over at every step, in turn: none, the engine's and server's
only, all (the model's layer and head sites too), and prints the median
wall of each kind among the decode-only steps, and the median step-to-
step differences, the marginal cost of each kind of site on one run's
traffic. The metrics are the cell's end-to-end ones (``--trace 0``) or its
per-layer ones (``--trace 1``), with the five metrics of the recorders
listed beside ``BENCHMARK.json``'s own. Every run prints one JSON line:
the result, the median and 95th percentile of the ``Engine.step`` walls in the window (timed
around the step alone, with no synchronisation, whether the recorders
are on or off), and with ``--trace 1 --record 1`` the idle stretches by
program site and the consistency checks of the recorders:

- ``live_rows``: ``engine.decode_live_pct`` * ``max_batch`` / 100 beside
  the harness's ``engine.decode_batch_mean``;
- ``idle_pct``: ``device.idle`` recomputed over the program's
  ``engine.step`` sites beside the harness's;
- ``ttft_accounted``: the share of the window's requests whose client
  TTFT equals, within 5 ms or 5%, due -> ``Engine.submit`` (the
  harness's) + ``engine.queue`` + the prefill's wall + the first token's
  hold, and the median of each part;
- ``recorder_us``: host microseconds a site pair costs the profiler
  (timed here, in a loop), the sites a step records, and the host
  milliseconds a window step spent inside the recorders' calls (each
  outermost call of the profiler, the tracer and the server's counter
  tracks timed where it is made).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import run as bench  # noqa: E402

SITE_METRICS = [
    ("engine.step_ms_p95", "ms", "lower", "program_span",
     "scheduler: core.serving.engine.Engine", "itl_p95_ms", False),
    ("engine.queue_ms_p50", "ms", "lower", "program_span",
     "scheduler: core.serving.engine.Engine", "ttft_p50_ms", False),
    ("engine.first_token_hold_ms_p50", "ms", "lower", "program_span",
     "scheduler: core.serving.engine.Engine", "ttft_p50_ms", False),
    ("engine.decode_live_pct", "%", "higher", "program_counter",
     "scheduler: core.serving.engine.Engine", "output_tok_s", False),
    ("moe.decode_buffer_fill_pct", "%", "higher", "program_counter",
     "model step: models.moe.apply_moe", "output_tok_s", True),
]


def bench_json(path: Path, src: Path = bench.ROOT / "BENCHMARK.json",
               cells=("qwen2vl-hires-image", "dsv3-chat-decode"),
               moe_cells=("dsv3-chat-decode",)) -> Path:
    """``src`` (``BENCHMARK.json``) with the recorders' metrics appended,
    for ``cells`` (the expert layer's for ``moe_cells``), written to
    ``path``."""
    with open(src) as f:
        doc = json.load(f)
    for name, unit, better, source, layer, moves, moe in SITE_METRICS:
        doc["per_layer"].append({
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": moves,
            "workloads": list(moe_cells if moe else cells)})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1))
    return path


RECORDER_CALLS = (("profiler", ("site_begin", "site_end", "close_laps")),
                  ("tracer", ("span_begin", "span_end", "span_abort",
                              "instant", "slice", "counter")),
                  ("server", ("_emit_counters",)))


def time_recorders(run, server) -> None:
    """Sum, in ``run.recorder_s`` (by call in ``run.recorder_calls``), the
    host time of the window's outermost calls into the recorders (a call
    made inside another is its part)."""
    run.recorder_calls, depth = {}, [0]
    for owner, names in RECORDER_CALLS:
        obj = {"profiler": run.profiler, "tracer": run.tracer,
               "server": server}[owner]
        for name in names:
            def timed(*a, _f=getattr(obj, name), _k=f"{owner}.{name}", **kw):
                if depth[0]:
                    return _f(*a, **kw)
                depth[0] = 1
                t0 = time.perf_counter()
                try:
                    return _f(*a, **kw)
                finally:
                    depth[0] = 0
                    if run.in_window(t0):
                        acc = run.recorder_calls.setdefault(_k, [0, 0.0])
                        acc[0] += 1
                        acc[1] += time.perf_counter() - t0
            setattr(obj, name, timed)


def toggled(run, server, step):
    """``step`` with the profiler's sites turned over at every step (see
    the module docstring); each window step's (kind, decode only, wall)
    kept in ``run.toggle_steps``."""
    from repro_torch.obs import NULL_PROFILER
    eng = server.engine
    kinds = ((NULL_PROFILER, NULL_PROFILER), (run.profiler, NULL_PROFILER),
             (run.profiler, run.profiler))
    run.toggle_steps, n, prefilled = [], [0], [False]
    chunk = eng._do_prefill_chunk

    def prefill(*a, **kw):
        prefilled[0] = True
        return chunk(*a, **kw)
    eng._do_prefill_chunk = prefill

    def one():
        k = n[0] % 3
        n[0] += 1
        eng.profiler = server.profiler = kinds[k][0]
        eng.model.profiler = kinds[k][1]
        prefilled[0] = False
        t0 = time.perf_counter()
        out = step()
        if run.in_window(t0):
            run.toggle_steps.append((k, not prefilled[0],
                                     time.perf_counter() - t0))
        return out
    return one


def toggle_summary(steps) -> dict:
    """Decode-only walls by kind (ms, median) and the median differences
    of consecutive decode-only steps, kind 1 - kind 0 (the engine's and
    server's sites) and kind 2 - kind 1 (the model's), in ms and % of
    kind 0's median."""
    import statistics
    by = {k: [w for kk, d, w in steps if kk == k and d] for k in range(3)}
    med = {k: statistics.median(v) * 1e3 for k, v in by.items() if v}
    out = {"decode_steps": {k: len(v) for k, v in by.items()},
           "median_ms": med}
    for a, b in ((0, 1), (1, 2)):
        diffs = [(w2 - w1) * 1e3 for (k1, d1, w1), (k2, d2, w2)
                 in zip(steps, steps[1:]) if (k1, k2) == (a, b) and d1
                 and d2]
        if diffs and med.get(0):
            d = statistics.median(diffs)
            out[f"diff_{a}{b}"] = [d, 100.0 * d / med[0], len(diffs)]
    return out


def recorded_run(record: bool, base, toggle: bool = False):
    """A ``harness.serve.Run`` (``base``) whose server keeps the recorders
    (when ``record``) and whose ``Engine.step`` calls are timed (and the
    profiler's sites turned over, with ``toggle``)."""

    class RecordedRun(base):
        made = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.step_walls = []
            RecordedRun.made.append(self)

        async def serve(self):
            from repro_torch.obs import Profiler, Tracer
            kw = {}
            if record:
                self.profiler, self.tracer = Profiler(), Tracer()
                kw = dict(obs=self.tracer, profile=self.profiler)
            orig = self.lvlm.serve_async

            def serve_async(ec, gen):
                server = orig(ec, gen, **kw)
                if record and self.trace:
                    time_recorders(self, server)
                step = server.engine.step
                if toggle:
                    step = toggled(self, server, step)

                def timed():
                    t0 = time.perf_counter()
                    out = step()
                    if self.in_window(t0):
                        self.step_walls.append(time.perf_counter() - t0)
                    return out
                server.engine.step = timed
                return server
            self.lvlm.serve_async = serve_async
            await super().serve()

    return RecordedRun


def recorder_cost(n: int = 20000) -> dict:
    """Host microseconds, in a loop, of one site pair with two attributes
    and of one reading of the clock."""
    from repro_torch.obs import Profiler
    p = Profiler()
    p.site_begin("outer")
    t0 = time.perf_counter()
    for _ in range(n):
        p.site_begin("model.decode")
        p.site_end("model.decode", rows_live=1, rows_launched=2)
    t1 = time.perf_counter()
    for _ in range(n):
        time.perf_counter()
    t2 = time.perf_counter()
    return {"site_pair_us": (t1 - t0) / n * 1e6,
            "clock_us": (t2 - t1) / n * 1e6}


def checks(run, out) -> dict:
    """The recorders' consistency checks (see the module docstring)."""
    from harness import sites
    from harness.stats import percentile
    got = {}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    if "engine.decode_live_pct" in m and "engine.decode_batch_mean" in m:
        got["live_rows"] = [m["engine.decode_live_pct"]
                            * run.ec.max_batch / 100.0,
                            m["engine.decode_batch_mean"]]
    every = sites.all_sites(run)
    if run.devtrace is not None and run.devtrace.has_device:
        v = sites.idle_share_in_sites(run.devtrace, every)
        got["idle_pct"] = [None if v is None else 100.0 * v,
                           m.get("device.idle")]
        got["idle_by_site"] = sites.idle_by_site(run.devtrace, every)
        got["idle_gaps"] = run.devtrace.idle_gaps()
    ev = sites.lifecycle(run)
    hold = dict(zip([r["rid"] for r in run.window_records()],
                    sites.first_token_hold_ms(run)))
    ok = n = 0
    worst, parts_of = [], []
    for r in run.window_records():
        if r["failed"]:
            continue
        n += 1
        rid = r["rid"]
        pb, pe = ev.get((rid, "prefill", "B")), ev.get((rid, "prefill", "E"))
        qb = ev.get((rid, "request", "B"))
        if None in (pb, pe, qb) or rid not in run.submit_t:
            continue
        parts = ((run.submit_t[rid] - r["due"]) * 1e3,
                 (pb - qb) * 1e3, (pe - pb) * 1e3, hold[rid])
        ttft = (r["times"][0] - r["due"]) * 1e3
        parts_of.append(parts + (ttft,))
        gap = ttft - sum(parts)
        if abs(gap) <= max(5.0, 0.05 * ttft):
            ok += 1
        worst.append(gap)
    if n:
        got["ttft_accounted"] = {
            "share": ok / n, "requests": n,
            "gap_ms_p50": percentile(worst, 50) if worst else None,
            "gap_ms_max": max(worst) if worst else None,
            "medians_ms": dict(zip(
                ("due_to_submit", "queue", "prefill", "hold", "ttft"),
                (percentile([q[i] for q in parts_of], 50)
                 for i in range(5)))) if parts_of else None}
    steps = sites.window_sites(run, "engine.step")
    if steps:
        prof = run.profiler
        lo, hi = prof.epoch_ns(run.ws), prof.epoch_ns(run.we)
        inside = sum(1 for s in every if lo <= s["t0_ns"] < hi)
        calls = getattr(run, "recorder_calls", {})
        got["recorder_us"] = dict(
            recorder_cost(), sites_per_step=inside / len(steps),
            ms_per_step=sum(s for _, s in calls.values()) * 1e3 / len(steps),
            us_per_step_by_call={k: [n / len(steps), s * 1e6 / len(steps)]
                                 for k, (n, s) in calls.items()},
            intervals_dropped=prof.intervals_dropped)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", choices=("1", "both", "toggle"),
                    default="1")
    args = ap.parse_args()
    bench._paths()
    import torch
    import harness.serve as hs
    from harness.stats import percentile

    bj = bench_json(bench.ROOT / ".perfbench_cache" / "record_bench.json")
    plan = []
    for i, seed in enumerate(args.seeds):
        if args.record == "both":
            order = (False, True) if i % 2 == 0 else (True, False)
        else:
            order = (True,)
        plan += [(seed, rec) for rec in order]
    t_start = T0
    base = hs.Run
    for seed, rec in plan:
        cls = recorded_run(rec, base, args.record == "toggle")
        hs.Run = cls
        out = bench.run_cell(args.workload, seed, args.seconds,
                             bool(args.trace), "cuda", bench_json=bj,
                             t_start=t_start)
        run = cls.made.pop()
        line = {"workload": args.workload, "seed": seed, "record": rec,
                "trace": args.trace, "correct": out["correct"],
                "attempted": out["attempted"], "failed": out["failed"],
                "metrics": {k: v["value"]
                            for k, v in out["metrics"].items()},
                "step_ms_p50": (percentile(run.step_walls, 50) or math.nan)
                * 1e3,
                "step_ms_p95": (percentile(run.step_walls, 95) or math.nan)
                * 1e3,
                "steps": len(run.step_walls), "device": out["device"]}
        if rec and args.trace:
            line["checks"] = checks(run, out)
        if args.record == "toggle":
            line["toggle"] = toggle_summary(run.toggle_steps)
        print(json.dumps(line), flush=True)
        del run, out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
