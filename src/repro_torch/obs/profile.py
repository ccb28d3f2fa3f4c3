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
    modeled cost, passed by the site) per named *site* -- the reference's
    (prefill forward, per-decoder-group decode launch, compression,
    KV-migration transfer, prefix-tier probe/install) and the port's own
    (``engine.step``, ``model.prefill`` / ``extend`` / ``decode``,
    ``model.attn`` / ``ffn`` / ``moe`` per layer, ``model.head``,
    ``engine.sample``, ``server.fan_out``; their virtual time is 0).
  * Sites nest (``compress`` runs inside ``prefill_forward``), and the
    profiler attributes wall time both ways: *total* (site entry to exit)
    and *self* (total minus enclosed child sites).
  * Every closed site is also kept as an interval: name, start and end on
    the host's clock, the enclosing site, and the small dict of
    attributes its ``site_end`` passed (shapes, ``rid``). A site that
    serves one request carries ``rid``, the key that joins it to the
    ``Tracer``'s lifecycle events. ``intervals()`` exports them in the
    epoch nanoseconds that ``torch.profiler``'s events use, through an
    anchor pair (``time.time_ns()``, the profiler's clock) read when the
    profiler is made, so host sites and device operations share one axis.
    Nothing is written out on the hot path.
  * A caller may also time a region itself and append ``(site, t0, t1,
    attrs)`` to ``Profiler.laps`` (``t0`` / ``t1`` read from
    ``Profiler.clock``): no call into the profiler per region.
    ``close_laps()`` then files them as closed sites inside the innermost
    open site, histograms and self time included. The model's layer sites
    are laps: in a host-bound decode step two profiler calls a layer half
    cost a few percent of the step, an append a tenth of that (PERF.md).

Profiling only ever READS clocks -- it never touches the PRNG key, the
scheduler, or the virtual clock -- so profiled runs stay bit-identical at
temperature 0 (locked by test).

Exports: ``profile_families`` renders Prometheus histogram families into a
``PromText`` (picked up by ``metrics_snapshot()``); ``intervals()`` gives
the sites one by one (``obs.perfetto.to_chrome_trace(sites=)`` draws them
on a wall-clock track).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

# intervals a profiler keeps before it stops recording new ones (the
# histograms go on): a few hundred MB of host memory at most
MAX_INTERVALS = 1 << 20

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

    def site_end(self, site: str, vt: float = 0.0, **attrs) -> None:
        pass

    def close_laps(self) -> None:
        pass

    # read-side surface (safe on the null profiler: empty results)
    def snapshot(self) -> Dict[str, Dict]:
        return {}

    def intervals(self) -> List[Dict]:
        return []


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


def _anchor(clock: Callable[[], float], reads: int = 5):
    """(epoch ns, clock reading) at one instant: ``time.time_ns()``
    bracketed by two readings of ``clock``, the tightest of ``reads``
    tries, its midpoint paired with the epoch reading."""
    best = None
    for _ in range(reads):
        a = clock()
        e = time.time_ns()
        b = clock()
        if best is None or b - a < best[0]:
            best = (b - a, e, 0.5 * (a + b))
    return best[1], best[2]


class Profiler(NullProfiler):
    """Enabled profiler: streaming log-bucket histograms per site, and
    every closed site as an interval (see the module docstring).

    One instance is shared by a whole fleet (like the Tracer): engine
    steps are synchronous, so begin/end pairs never interleave across
    replicas and a single site stack is sufficient for self/total
    attribution.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        # the host's clock: the sites' and the caller-timed laps'
        self.clock = clock
        self._sites: Dict[str, _Site] = {}
        # open-site stack: [site, t0, child_wall_total, interval index]
        self._stack: List[List] = []
        # intervals in begin order: (site, t0, t1, parent index, attrs);
        # t1 stays None for a site that was never closed. Tuples: those of
        # atoms alone (most) the garbage collector stops tracking, so a
        # long recording lengthens its full collections little
        self._spans: List[tuple] = []
        self.max_intervals = MAX_INTERVALS
        self.intervals_dropped = 0
        # regions the caller timed itself (see the module docstring)
        self.laps: List[tuple] = []
        self.anchor_epoch_ns, self.anchor_clock = _anchor(clock)

    # ------------------------------------------------------ recording --
    def site_begin(self, site: str) -> None:
        t = self.clock()
        stack, spans = self._stack, self._spans
        idx = len(spans)
        if idx < self.max_intervals:
            spans.append((site, t, None, stack[-1][3] if stack else -1,
                          None))
        else:
            idx = -1
            self.intervals_dropped += 1
        stack.append([site, t, 0.0, idx])

    def site_end(self, site: str, vt: float = 0.0, **attrs) -> None:
        """Close the innermost open ``site``; ``attrs`` (host numbers:
        shapes, ``rid``) ride on its interval."""
        stack = self._stack
        if stack and stack[-1][0] == site:
            frame = stack.pop()
        else:
            # unwind to the matching frame (defensive: a site that leaked
            # an inner begin is discarded rather than corrupting
            # attribution)
            frame = None
            while stack:
                top = stack.pop()
                if top[0] == site:
                    frame = top
                    break
            if frame is None:
                return
        now = self.clock()
        total = now - frame[1]
        self_w = total - frame[2]
        if self_w < 0.0:
            self_w = 0.0
        if stack:
            stack[-1][2] += total
        rec = self._sites.get(site)
        if rec is None:
            rec = self._sites[site] = _Site()
        rec.add(total, self_w, vt)
        if frame[3] >= 0:
            span = self._spans[frame[3]]
            self._spans[frame[3]] = (site, span[1], now, span[3],
                                     attrs or None)

    def close_laps(self) -> None:
        """File ``laps`` as closed sites inside the innermost open site."""
        stack, spans = self._stack, self._spans
        parent = stack[-1][3] if stack else -1
        inside = 0.0
        for site, t0, t1, attrs in self.laps:
            total = t1 - t0
            inside += total
            rec = self._sites.get(site)
            if rec is None:
                rec = self._sites[site] = _Site()
            rec.add(total, total, 0.0)
            if len(spans) < self.max_intervals:
                spans.append((site, t0, t1, parent, attrs))
            else:
                self.intervals_dropped += 1
        if stack:
            stack[-1][2] += inside
        self.laps.clear()

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

    def epoch_ns(self, t: float) -> int:
        """A reading of this profiler's clock (the ``Tracer``'s ``wt``
        too, when both keep the default ``time.perf_counter``) in the
        epoch nanoseconds of ``torch.profiler``'s events."""
        return self.anchor_epoch_ns + int(round(
            (t - self.anchor_clock) * 1e9))

    def intervals(self) -> List[Dict]:
        """The closed sites in begin order: ``name``, ``t0_ns`` /
        ``t1_ns`` (epoch ns), ``parent`` (index in this list of the
        innermost enclosing closed site, -1 at the top) and ``attrs``."""
        out: List[Dict] = []
        index: List[int] = []          # self._spans index -> out index
        for name, t0, t1, parent, attrs in self._spans:
            while parent >= 0 and index[parent] < 0:
                parent = self._spans[parent][3]      # skip an unclosed one
            if t1 is None:
                index.append(-1)
                continue
            index.append(len(out))
            out.append({"name": name, "t0_ns": self.epoch_ns(t0),
                        "t1_ns": self.epoch_ns(t1),
                        "parent": index[parent] if parent >= 0 else -1,
                        "attrs": dict(attrs or {})})
        return out


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
