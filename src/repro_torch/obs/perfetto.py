"""Chrome-trace / Perfetto JSON export of a ``Tracer`` event log.

Port of ``repro.obs.perfetto`` (the port keeps its own copy).

Mapping (chrome://tracing "JSON Array Format" / Perfetto-loadable):

  * one **process** per replica (``pid`` = replica index, named
    ``replica{i}`` via process_name metadata),
  * lifecycle spans -> **async events** (``ph`` ``"b"``/``"e"``,
    ``id`` = rid, ``cat`` = ``"request"``) so overlapping stages of one
    request (admission wait inside the request span, migration spanning
    two replicas) render as nested tracks without the strict
    begin/end nesting B/E slices require,
  * engine-step / slot activity (tracer ``slice``) -> **complete
    events** (``ph`` ``"X"``) on ``tid`` lanes: lane 0 is the engine
    pump, lane ``1 + slot`` is that engine slot,
  * instants -> ``ph`` ``"i"``, counters -> ``ph`` ``"C"`` (one counter
    track per name per replica: KV watermark, admission queue depth,
    prefix-tier hits, migration bytes in flight).

Timestamps: Perfetto wants microseconds. The **virtual clock** is the
primary timeline (deterministic; what the cost model charged) --
``vt * 1e6``. Wall time rides along in ``args.wall_s`` on every event
so per-stage wall attribution survives the export.

``sites=`` (a ``Profiler``'s ``intervals()``) adds the profiler's host
sites as complete events on a process of their own (``pid``
``SITES_PID``, "host sites (wall clock)"), at their epoch microseconds:
the clock of a ``torch.profiler`` ``export_chrome_trace``, so the two
files open on one timeline. A site's attributes are its ``args``.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

ENGINE_LANE = 0                 # tid of the engine pump lane
SLOT_LANE_BASE = 1              # tid of slot s is SLOT_LANE_BASE + s
SITES_PID = 1 << 20             # pid of the host sites' wall-clock track

_PH = {"B": "b", "E": "e", "i": "i", "X": "X", "C": "C"}


def _us(vt) -> float:
    return float(vt or 0.0) * 1e6


def to_chrome_trace(events: Iterable[Dict],
                    sites: Optional[Iterable[Dict]] = None) -> Dict:
    """Convert tracer events (and profiler ``sites``) to a
    ``{"traceEvents": [...]}`` dict (load via chrome://tracing or
    ui.perfetto.dev)."""
    out: List[Dict] = []
    reps = set()
    for ev in events:
        pid = int(ev.get("rep", 0))
        reps.add(pid)
        kind = ev["k"]
        ph = _PH.get(kind)
        if ph is None:
            continue
        args: Dict = {"wall_s": ev.get("wt")}
        if ev.get("attrs"):
            args.update(ev["attrs"])
        te: Dict = {"name": ev["name"], "ph": ph, "pid": pid,
                    "ts": _us(ev.get("vt")), "args": args}
        if kind in ("B", "E"):
            # async event pair: id groups begin/end across replicas
            te["cat"] = "request"
            te["id"] = ev.get("rid", 0)
            te["tid"] = ENGINE_LANE
        elif kind == "X":
            slot = ev.get("slot")
            te["tid"] = (ENGINE_LANE if slot is None
                         else SLOT_LANE_BASE + int(slot))
            te["dur"] = _us(ev.get("dur"))
            if ev.get("rid") is not None:
                args["rid"] = ev["rid"]
        elif kind == "i":
            te["tid"] = ENGINE_LANE
            te["s"] = "t"                      # thread-scoped instant
            if ev.get("rid") is not None:
                args["rid"] = ev["rid"]
        elif kind == "C":
            te["tid"] = ENGINE_LANE
            te["args"] = {"value": ev.get("value", 0)}
        out.append(te)
    meta = []
    for pid in sorted(reps):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"replica{pid}"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": ENGINE_LANE, "args": {"name": "engine"}})
    if sites is not None:
        meta.append({"name": "process_name", "ph": "M", "pid": SITES_PID,
                     "args": {"name": "host sites (wall clock)"}})
        out.extend({"name": s["name"], "ph": "X", "pid": SITES_PID,
                    "tid": ENGINE_LANE, "ts": s["t0_ns"] * 1e-3,
                    "dur": (s["t1_ns"] - s["t0_ns"]) * 1e-3,
                    "args": dict(s["attrs"])} for s in sites)
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Iterable[Dict], path: str,
                       sites: Optional[Iterable[Dict]] = None) -> int:
    """Write the Chrome-trace JSON; returns the traceEvents count."""
    doc = to_chrome_trace(events, sites)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
