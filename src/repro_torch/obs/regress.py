"""Perf-regression gate over ``BENCH_*.json`` (and other metric) pairs.

Port of ``repro.obs.regress`` (its own copy: the port imports no module
of ``repro``); the same flattening, gating directions, exit codes and
report lines.

    python -m repro_torch.obs.regress CURRENT BASELINE --tolerance 0.5

Compares every numeric leaf the two JSON documents share and exits 1 if
any *gated* metric regressed beyond the tolerance. The comparator is
generic over nested dicts/lists -- it handles ``BENCH_kernels.json``
(per-kernel timing rows), ``BENCH_serving.json`` (virtual/wall serving
stats + the embedded profile block), and ``scripts/trace_report.py
--json`` stage-attribution documents with the same code path:

  * documents are flattened to dotted paths; list elements are keyed by
    an identifying field (``kernel``/``scenario``/``name``/``site``,
    plus ``shape`` when present) so reordering rows is not a diff;
  * a leaf is gated HIGHER-IS-WORSE when its path looks like a latency
    (``us_per_call``, ``*_s``, ``*_us``, ``ttft``/``tpot``, ``wall``,
    ``seconds``, ``queue_wait``) and HIGHER-IS-BETTER when it looks like
    a rate (``throughput``, ``tok_per_s``, ``goodput``, ``attainment``,
    ``hit_rate``); everything else (counts, schema versions, shares,
    noise stats like ``std``) is informational only;
  * regression means ``ratio > 1 + tolerance`` where ratio is
    current/baseline for higher-is-worse and baseline/current for
    higher-is-better -- symmetric, and safe for tolerances > 1 (CI uses
    a generous tolerance so a committed same-machine baseline gates
    hosted runners without flaking).

Leaves present in only one document are reported but never gate (a new
kernel row must not fail the gate that introduces it).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

# path substrings that decide gating direction (checked on the full
# dotted path, lowercase)
_HIGHER_WORSE = ("us_per_call", "_us", "_s.", "time_s", "ttft", "tpot",
                 "seconds", "wall", "queue_wait", "jct")
_HIGHER_BETTER = ("throughput", "tok_per_s", "goodput", "attainment",
                  "hit_rate", "quality_proxy")
# leaf names that are never gated even under a matching path (noise or
# bookkeeping, not performance). rate_rps/retained_visual_ratio are a
# pareto row's identity/configuration, not measurements; acceptance is
# folded into quality_proxy.
_UNGATED_LEAVES = ("std", "count", "iters", "schema_version", "share",
                   "rate_rps", "retained_visual_ratio", "acceptance",
                   "replicas")

_ID_FIELDS = ("kernel", "scenario", "name", "site", "stage")

# composite identity of a BENCH_pareto.json sweep row: one grid point is
# (compression preset x decoder x replica mix x arrival rate), so a row
# keyed this way matches its baseline row regardless of sweep order
_PARETO_ID_FIELDS = ("compression", "decoder", "mix", "rate_rps")


def _item_key(item, i: int) -> str:
    if isinstance(item, dict):
        if all(f in item for f in _PARETO_ID_FIELDS):
            return "|".join(str(item[f]) for f in _PARETO_ID_FIELDS)
        for f in _ID_FIELDS:
            if f in item and isinstance(item[f], str):
                key = item[f]
                if isinstance(item.get("shape"), str):
                    key += "/" + item["shape"]
                return key
    return str(i)


def flatten(doc, prefix: str = "") -> Dict[str, float]:
    """Numeric leaves of a nested JSON document as {dotted.path: value}."""
    out: Dict[str, float] = {}
    if isinstance(doc, dict):
        for k, v in doc.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(doc, list):
        for i, item in enumerate(doc):
            out.update(flatten(item, f"{prefix}{_item_key(item, i)}."))
    elif isinstance(doc, bool):
        pass
    elif isinstance(doc, (int, float)):
        out[prefix[:-1]] = float(doc)
    return out


def _direction(path: str) -> int:
    """+1 higher-is-worse, -1 higher-is-better, 0 informational."""
    p = path.lower()
    leaf = p.rsplit(".", 1)[-1]
    if leaf in _UNGATED_LEAVES:
        return 0
    if any(s in p for s in _HIGHER_BETTER):
        return -1
    # trailing "_s" needs the sentinel dot trick to also match leaves
    if any(s in p + "." for s in _HIGHER_WORSE):
        return 1
    return 0


def compare(current: Dict, baseline: Dict, tolerance: float
            ) -> Tuple[List[Tuple[str, float, float, float]],
                       List[Tuple[str, float, float, float]]]:
    """Returns (regressions, compared): each entry is
    (path, current, baseline, ratio) with ratio oriented so that > 1
    means worse. Only gated leaves present in BOTH documents appear."""
    cur = flatten(current)
    base = flatten(baseline)
    compared, regressions = [], []
    for path in sorted(set(cur) & set(base)):
        d = _direction(path)
        if d == 0:
            continue
        c, b = cur[path], base[path]
        if b <= 0.0 or c <= 0.0:
            continue          # zero/negative timings carry no signal
        ratio = (c / b) if d > 0 else (b / c)
        compared.append((path, c, b, ratio))
        if ratio > 1.0 + tolerance:
            regressions.append((path, c, b, ratio))
    return regressions, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Gate a BENCH_*.json (or trace_report --json) "
                    "document against a committed baseline.")
    ap.add_argument("current", help="freshly produced metrics JSON")
    ap.add_argument("baseline", help="committed baseline JSON")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="allowed relative slowdown (0.5 = 50%% worse "
                         "passes; default %(default)s)")
    ap.add_argument("--list", action="store_true",
                    help="print every compared metric, not just "
                         "regressions")
    args = ap.parse_args(argv)

    with open(args.current) as f:
        current = json.load(f)
    with open(args.baseline) as f:
        baseline = json.load(f)
    regressions, compared = compare(current, baseline, args.tolerance)

    only = set(flatten(current)) ^ set(flatten(baseline))
    if args.list:
        for path, c, b, ratio in compared:
            print(f"  {path}: {c:.6g} vs {b:.6g} (x{ratio:.3f})")
    print(f"regress: {len(compared)} gated metrics compared, "
          f"{len(only)} present in one document only, "
          f"tolerance {args.tolerance:g}")
    if regressions:
        for path, c, b, ratio in regressions:
            print(f"REGRESSION {path}: {c:.6g} vs baseline {b:.6g} "
                  f"(x{ratio:.3f} > x{1.0 + args.tolerance:.3f})")
        return 1
    print("regress: OK (no metric beyond tolerance)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
