"""The program's own recorders in a run: its profiler's host sites and its
tracer's request lifecycle, read over the window.

A run that keeps them holds ``run.profiler`` (a ``repro_torch.obs.
Profiler``: every closed site as an interval in epoch nanoseconds) and
``run.tracer`` (a ``repro_torch.obs.Tracer``: each request's ``request``,
``prefill`` ... events with their wall ``wt``), passed to
``LVLM.serve_async(obs=, profile=)``. Without them every reader here
returns None. The harness's clock (``time.perf_counter``), the tracer's
``wt`` and the profiler's own clock are one clock; the profiler's anchor
(``Profiler.epoch_ns``) moves a reading of it onto the device trace's
epoch nanoseconds.

- the window's sites: those whose start lies in ``[ws, we)``;
- the window's requests: those due in it (``Run.window_records``);
- ``idle_by_site``: the device trace's idle stretches (the ones
  ``DeviceTrace.idle_gaps`` takes), cut at the sites' edges, each piece
  named by the innermost site open over it (``between steps`` where
  none is).
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

from harness.stats import percentile

OUTSIDE = "between steps"


def recorders(run):
    """(profiler, tracer) of the run, or (None, None) when it kept none."""
    prof = getattr(run, "profiler", None)
    tracer = getattr(run, "tracer", None)
    if prof is None or not getattr(prof, "enabled", False) \
            or tracer is None or not getattr(tracer, "enabled", False):
        return None, None
    return prof, tracer


def all_sites(run) -> List[Dict]:
    """Every closed site of the run (cached on the run)."""
    prof, _ = recorders(run)
    if prof is None:
        return []
    if getattr(run, "_sites", None) is None:
        run._sites = prof.intervals()
    return run._sites


def window_sites(run, name: str) -> List[Dict]:
    prof, _ = recorders(run)
    if prof is None or run.ws is None or run.we is None:
        return []
    lo, hi = prof.epoch_ns(run.ws), prof.epoch_ns(run.we)
    return [s for s in all_sites(run)
            if s["name"] == name and lo <= s["t0_ns"] < hi]


def lifecycle(run) -> Dict[Tuple[int, str, str], float]:
    """(rid, span name, "B" | "E") -> the tracer's ``wt`` of its first
    such event."""
    _, tracer = recorders(run)
    out: Dict[Tuple[int, str, str], float] = {}
    for ev in tracer.events if tracer is not None else ():
        if ev["k"] in ("B", "E") and "rid" in ev:
            out.setdefault((ev["rid"], ev["name"], ev["k"]), ev["wt"])
    return out


def ms(ns: int) -> float:
    return ns * 1e-6


# ---------------------------------------------------------------- readers --
def step_ms(run, p: float) -> Optional[float]:
    """``p``-th percentile of the window's ``engine.step`` walls, ms."""
    walls = [ms(s["t1_ns"] - s["t0_ns"])
             for s in window_sites(run, "engine.step")]
    return percentile(walls, p)


def queue_ms(run) -> List[float]:
    """Each window request's wall from ``Engine.submit`` (the tracer's
    ``request`` begin) to its ``prefill`` begin, ms; +inf where either
    is missing."""
    ev = lifecycle(run)
    out = []
    for r in run.window_records():
        a = ev.get((r["rid"], "request", "B"))
        b = ev.get((r["rid"], "prefill", "B"))
        out.append(math.inf if a is None or b is None else (b - a) * 1e3)
    return out


def first_token_hold_ms(run) -> List[float]:
    """Each window request's wall from its ``prefill`` end (its first token
    sampled on the host) to the end of the ``engine.step`` site around
    it, ms; +inf where either is missing."""
    prof, _ = recorders(run)
    ev = lifecycle(run)
    steps = sorted((s["t0_ns"], s["t1_ns"]) for s in all_sites(run)
                   if s["name"] == "engine.step")
    starts = [a for a, _ in steps]
    out = []
    for r in run.window_records():
        wt = ev.get((r["rid"], "prefill", "E"))
        hold = math.inf
        if wt is not None:
            t = prof.epoch_ns(wt)
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= steps[i][1]:
                hold = ms(steps[i][1] - t)
        out.append(hold)
    return out


def decode_live_pct(run) -> Optional[float]:
    """Live rows over launched rows of the window's ``model.decode``
    sites, %."""
    sites = window_sites(run, "model.decode")
    launched = sum(s["attrs"]["rows_launched"] for s in sites)
    if not launched:
        return None
    return 100.0 * sum(s["attrs"]["rows_live"] for s in sites) / launched


def moe_decode_fill_pct(run) -> Optional[float]:
    """Dispatched pairs over buffer rows of the ``model.moe`` sites inside
    the window's ``model.decode`` sites, %."""
    sites = all_sites(run)
    decodes = {id(s) for s in window_sites(run, "model.decode")}
    pairs = rows = 0
    for s in sites:
        if s["name"] != "model.moe":
            continue
        p = s["parent"]
        while p >= 0 and sites[p]["name"] != "model.decode":
            p = sites[p]["parent"]
        if p >= 0 and id(sites[p]) in decodes:
            pairs += s["attrs"]["pairs"]
            rows += s["attrs"]["buffer_rows"]
    return 100.0 * pairs / rows if rows else None


# -------------------------------------------------- against the device --
def innermost(sites: List[Dict], lo: int, hi: int) -> List[Tuple]:
    """(start, end, name) pieces covering ``[lo, hi)``: the innermost
    site open over each (``OUTSIDE`` where none is). Sites nest, as one
    thread's recorder gives them."""
    out: List[Tuple] = []
    stack: List[Dict] = []
    t = lo

    def emit(a, b):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, stack[-1]["name"] if stack else OUTSIDE))

    def close_until(when):
        nonlocal t
        while stack and stack[-1]["t1_ns"] <= when:
            end = stack[-1]["t1_ns"]
            emit(t, end)
            stack.pop()
            t = max(t, end)

    for s in sorted(sites, key=lambda s: (s["t0_ns"], -s["t1_ns"])):
        if s["t1_ns"] <= lo or s["t0_ns"] >= hi:
            continue
        close_until(s["t0_ns"])
        emit(t, s["t0_ns"])
        t = max(t, s["t0_ns"])
        stack.append(s)
    close_until(math.inf)
    emit(t, hi)
    return out


def idle_stretches(dt, min_ns: int = 10_000) -> List[Tuple[int, int]]:
    """The traced stretch's intervals with no device operation, at least
    ``min_ns`` long (as ``DeviceTrace.idle_gaps`` takes them)."""
    out = []
    prev = dt.t0
    for s, e in dt.busy_iv + [(dt.t1, dt.t1)]:
        s, e = max(s, dt.t0), min(e, dt.t1)
        if s - prev >= min_ns:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def idle_by_site(dt, sites: List[Dict], n: int = 12,
                 min_ns: int = 10_000) -> List[List]:
    """The idle stretches summed by the innermost program site open over
    each piece, longest first: [[name, seconds], ...]."""
    pieces = innermost(sites, dt.t0, dt.t1)
    acc: Dict[str, int] = {}
    j = 0
    for a, b in idle_stretches(dt, min_ns):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                acc[pieces[k][2]] = acc.get(pieces[k][2], 0) + (hi - lo)
            k += 1
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v * 1e-9] for k, v in top]


def idle_share_in_sites(dt, sites: List[Dict]) -> Optional[float]:
    """Share of the time inside the ``engine.step`` sites that lie in the
    traced stretch with no device operation (``device.idle`` recomputed
    on the program's sites)."""
    steps = [(s["t0_ns"], s["t1_ns"]) for s in sites
             if s["name"] == "engine.step"
             and dt.t0 <= s["t0_ns"] and s["t1_ns"] <= dt.t1]
    total = sum(e - s for s, e in steps)
    if not total or not dt.ops:
        return None
    starts = [a for a, _ in dt.busy_iv]
    busy = 0
    for s, e in steps:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(dt.busy_iv) and dt.busy_iv[i][0] < e:
            a, b = dt.busy_iv[i]
            busy += max(0, min(b, e) - max(a, s))
            i += 1
    return 1.0 - busy / total
