"""Continuous hot-path profiling: streaming per-site time histograms.

Port of ``repro.obs.profile`` (the port keeps its own copy). On CUDA a
site's wall time reads ``time.perf_counter`` on the host: it includes
device time only up to the host's last synchronisation inside the site
(PERF.md says what each site measures on the card).

Where ``repro_torch.obs.trace`` answers "what happened to request N" (lifecycle
spans), this module answers "where does an engine step actually spend its
time" -- continuously, in production, with the same zero-overhead-when-off
discipline:

  * ``NULL_PROFILER`` (a ``NullProfiler``) is the default everywhere; its
    ``enabled`` class attribute is ``False`` and every hot-path site guards
    on it (``if profiler.enabled:``), so the unprofiled path makes ZERO
    profiler calls (locked by a patch-the-null-profiler-to-raise test,
    mirroring the NullTracer test).
  * ``Profiler`` accumulates streaming log2-bucket histograms of wall time
    (``time.perf_counter`` around the site) and virtual time (the engine's
    modeled cost, passed by the site) per named *site* -- prefill forward,
    per-decoder-group decode launch, compression, KV-migration transfer,
    prefix-tier probe/install.
  * Sites nest (``compress`` runs inside ``prefill_forward``), and the
    profiler attributes wall time both ways: *total* (site entry to exit)
    and *self* (total minus enclosed child sites). Nesting paths feed the
    collapsed-stack (flamegraph-compatible) export.

Profiling only ever READS clocks -- it never touches the PRNG key, the
scheduler, or the virtual clock -- so profiled runs stay bit-identical at
temperature 0 (locked by test).

Exports: ``profile_families`` renders Prometheus histogram families into a
``PromText`` (picked up by ``metrics_snapshot()``), ``Profiler.write_json``
writes the full document (histograms + collapsed stacks), and
``Profiler.bench_record`` is the schema-v1 scalar block a benchmark
record embeds.
"""
from __future__ import annotations

import json
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

# log2 histogram upper bounds in seconds: 1us * 2**i -- 30 buckets cover
# 1us .. ~537s, far beyond any single hot-path site on any hardware
_BUCKET_BASE = 1e-6
_NUM_BUCKETS = 30


def bucket_bounds() -> List[float]:
    """The histogram's upper bounds in seconds (shared by all sites)."""
    return [_BUCKET_BASE * (1 << i) for i in range(_NUM_BUCKETS)]


def _bucket_index(x: float) -> int:
    if x <= _BUCKET_BASE:
        return 0
    i = int(math.ceil(math.log2(x / _BUCKET_BASE)))
    return min(max(i, 0), _NUM_BUCKETS - 1)


class NullProfiler:
    """Disabled profiler: every method is a no-op and ``enabled`` is a
    class attribute so the hot-path guard is one attribute load. Sites
    must NEVER call these when profiling is off -- guard with
    ``if profiler.enabled:`` (rule O003 checks site pairing; the
    patch-to-raise test checks the guards)."""

    enabled = False

    def site_begin(self, site: str) -> None:
        pass

    def site_end(self, site: str, vt: float = 0.0) -> None:
        pass

    # read-side surface (safe on the null profiler: empty results)
    def snapshot(self) -> Dict[str, Dict]:
        return {}

    def collapsed(self) -> List[str]:
        return []

    def bench_record(self) -> Dict:
        return {"schema_version": 1, "sites": {}}


NULL_PROFILER = NullProfiler()


class _Site:
    __slots__ = ("count", "wall_total", "wall_self", "virtual",
                 "wall_counts", "virtual_counts")

    def __init__(self) -> None:
        self.count = 0
        self.wall_total = 0.0
        self.wall_self = 0.0
        self.virtual = 0.0
        self.wall_counts = [0] * _NUM_BUCKETS
        self.virtual_counts = [0] * _NUM_BUCKETS

    def add(self, total: float, self_w: float, vt: float) -> None:
        self.count += 1
        self.wall_total += total
        self.wall_self += self_w
        self.virtual += vt
        self.wall_counts[_bucket_index(total)] += 1
        self.virtual_counts[_bucket_index(vt)] += 1


def _trim_buckets(counts: List[int]) -> List[List[float]]:
    """[(upper_bound_s, count), ...] up to the last non-empty bucket --
    cumulative rendering stays exact (all trimmed buckets are zero)."""
    last = -1
    for i, c in enumerate(counts):
        if c:
            last = i
    bounds = bucket_bounds()
    return [[bounds[i], counts[i]] for i in range(last + 1)]


class Profiler(NullProfiler):
    """Enabled profiler: streaming log-bucket histograms per site.

    One instance is shared by a whole fleet (like the Tracer): engine
    steps are synchronous, so begin/end pairs never interleave across
    replicas and a single site stack is sufficient for self/total
    attribution.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._sites: Dict[str, _Site] = {}
        # open-site stack: [site, t0, child_wall_total] frames
        self._stack: List[List] = []
        # collapsed stacks: "outer;inner" -> self wall seconds
        self._paths: Dict[str, float] = {}

    # ------------------------------------------------------ recording --
    def site_begin(self, site: str) -> None:
        self._stack.append([site, self._clock(), 0.0])

    def site_end(self, site: str, vt: float = 0.0) -> None:
        # unwind to the matching frame (defensive: a site that leaked an
        # inner begin is discarded rather than corrupting attribution)
        frame = None
        while self._stack:
            top = self._stack.pop()
            if top[0] == site:
                frame = top
                break
        if frame is None:
            return
        total = self._clock() - frame[1]
        self_w = total - frame[2]
        if self_w < 0.0:
            self_w = 0.0
        if self._stack:
            self._stack[-1][2] += total
            path = ";".join(f[0] for f in self._stack) + ";" + site
        else:
            path = site
        rec = self._sites.get(site)
        if rec is None:
            rec = self._sites[site] = _Site()
        rec.add(total, self_w, vt)
        self._paths[path] = self._paths.get(path, 0.0) + self_w

    # ------------------------------------------------------- exports --
    def snapshot(self) -> Dict[str, Dict]:
        """Per-site accumulators: counts, wall self/total, virtual time,
        and trimmed (upper_bound_s, count) histogram buckets."""
        out: Dict[str, Dict] = {}
        for site, s in sorted(self._sites.items()):
            out[site] = {
                "count": s.count,
                "wall_total_s": s.wall_total,
                "wall_self_s": s.wall_self,
                "virtual_s": s.virtual,
                "wall_buckets": _trim_buckets(s.wall_counts),
                "virtual_buckets": _trim_buckets(s.virtual_counts),
            }
        return out

    def collapsed(self) -> List[str]:
        """Collapsed-stack lines (``outer;inner <self_usec>``) -- feed to
        any flamegraph renderer (e.g. flamegraph.pl, speedscope)."""
        return [f"{path} {max(1, int(round(us * 1e6)))}"
                for path, us in sorted(self._paths.items())]

    def bench_record(self) -> Dict:
        """The schema-v1 profile block for ``--emit-bench`` records:
        scalar per-site attribution only (histograms stay in
        ``write_json``; bench records are for regression gating)."""
        sites = {}
        for site, s in sorted(self._sites.items()):
            sites[site] = {
                "count": s.count,
                "wall_total_s": s.wall_total,
                "wall_self_s": s.wall_self,
                "virtual_s": s.virtual,
            }
        return {"schema_version": 1, "sites": sites}

    def write_json(self, path: str) -> None:
        """Full profile document: per-site histograms and collapsed stacks."""
        doc = {
            "schema_version": 1,
            "kind": "profile",
            "sites": self.snapshot(),
            "collapsed": {p: v for p, v in sorted(self._paths.items())},
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")


def profile_families(prom, profiler, *,
                     labels: Optional[Dict[str, str]] = None) -> None:
    """Render a profiler's per-site families into a ``PromText``:
    ``repro_profile_wall_seconds`` / ``repro_profile_virtual_seconds``
    histograms plus self-time counters, labeled by ``site``."""
    snap = profiler.snapshot()
    for site, s in snap.items():
        lab = dict(labels or {})
        lab["site"] = site
        prom.histogram(
            "profile_wall_seconds",
            "Wall time per hot-path site call (log2 buckets).",
            s["wall_buckets"], s["wall_total_s"], s["count"], labels=lab)
        prom.histogram(
            "profile_virtual_seconds",
            "Modeled virtual time per hot-path site call (log2 buckets).",
            s["virtual_buckets"], s["virtual_s"], s["count"], labels=lab)
        prom.counter(
            "profile_wall_self_seconds_total",
            "Cumulative self wall time (enclosed child sites excluded).",
            s["wall_self_s"], labels=lab)
