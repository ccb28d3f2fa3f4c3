"""Trace validation: ``python -m repro_torch.obs.validate TRACE [--require-migrations]``.

Port of ``repro.obs.validate`` (the port keeps its own copy).

Machine-checks a trace is complete and well-formed -- the CI gate for
the traced disagg-burst run:

  * **balanced spans**: every ``b`` has a matching ``e`` per
    ``(id, name)`` -- zero orphans (an aborted request still closes;
    see ``Tracer.span_abort``);
  * **monotonic clocks**: per request, the virtual (``ts``) and wall
    (``args.wall_s``) timestamps never go backwards across its span
    boundary events -- the migration hand-off may not rewind either
    clock;
  * **Perfetto-loadable**: top-level ``traceEvents`` list, every event
    carries ``name``/``ph``/``pid``/``ts``, ``X`` events carry ``dur``;
  * with ``--require-migrations``: every request span saw >= 1
    ``kv_migration`` span (the disaggregated-fleet acceptance shape).

Accepts the Chrome-trace JSON written by ``repro_torch.obs.perfetto`` or the
raw tracer JSONL (one event dict per line, converted on the fly).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from repro_torch.obs.perfetto import to_chrome_trace


def load_trace(path: str) -> Dict:
    """Load Chrome-trace JSON, or tracer JSONL (converted)."""
    with open(path, "r", encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            try:
                doc = json.load(f)
            except json.JSONDecodeError:
                doc = None               # JSONL: one dict per line
            if isinstance(doc, dict) and "traceEvents" in doc:
                return doc
            f.seek(0)
        events = [json.loads(line) for line in f if line.strip()]
    return to_chrome_trace(events)


def validate_trace(doc: Dict, *,
                   require_migrations: bool = False) -> List[str]:
    """Return a list of problems (empty == valid)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["not Perfetto-loadable: no top-level traceEvents list"]

    open_spans: Dict[Tuple, Dict] = {}
    # per-rid last-seen clocks over span boundary events
    last_vt: Dict = {}
    last_wt: Dict = {}
    migrated: set = set()
    requests: set = set()

    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        for field in ("name", "ph", "pid", "ts"):
            if field not in ev:
                problems.append(
                    f"event {i}: not Perfetto-loadable, missing {field!r}")
        if ph == "X" and "dur" not in ev:
            problems.append(f"event {i}: X event missing dur")
        if ph not in ("b", "e"):
            continue

        rid = ev.get("id")
        name = ev.get("name")
        key = (rid, name)
        if name == "request":
            requests.add(rid)
        elif name == "kv_migration":
            migrated.add(rid)
        if ph == "b":
            if key in open_spans:
                problems.append(f"event {i}: double-begin {key}")
            open_spans[key] = ev
        else:
            if key not in open_spans:
                problems.append(f"event {i}: end without begin {key}")
            else:
                del open_spans[key]

        vt = ev.get("ts", 0.0)
        wt = (ev.get("args") or {}).get("wall_s")
        if rid in last_vt and vt < last_vt[rid]:
            problems.append(
                f"event {i}: rid {rid} virtual clock went backwards "
                f"({last_vt[rid]} -> {vt})")
        last_vt[rid] = vt
        if wt is not None:
            if rid in last_wt and wt < last_wt[rid]:
                problems.append(
                    f"event {i}: rid {rid} wall clock went backwards "
                    f"({last_wt[rid]} -> {wt})")
            last_wt[rid] = wt

    for key in open_spans:
        problems.append(f"orphan span (never closed): {key}")
    if require_migrations:
        for rid in sorted(requests - migrated):
            problems.append(f"rid {rid}: no kv_migration span "
                            "(disaggregated fleet expected one)")
    if not requests:
        problems.append("trace contains no request spans")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="Validate a repro_torch.obs trace (Chrome JSON or JSONL).")
    ap.add_argument("trace", help="trace file to validate")
    ap.add_argument("--require-migrations", action="store_true",
                    help="fail unless every request migrated >= once")
    args = ap.parse_args(argv)

    doc = load_trace(args.trace)
    problems = validate_trace(
        doc, require_migrations=args.require_migrations)
    n = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M") \
        if isinstance(doc.get("traceEvents"), list) else 0
    if problems:
        for p in problems:
            print(f"FAIL: {p}", file=sys.stderr)
        print(f"{args.trace}: {len(problems)} problem(s) in {n} events",
              file=sys.stderr)
        return 1
    print(f"{args.trace}: OK ({n} events, 0 orphan spans)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
