"""``Tracer``: per-request lifecycle spans with dual clocks.

Port of ``repro.obs.trace`` (the port keeps its own copy: it imports
no module of ``repro``).

The tracing contract the whole serving stack instruments against:

  * **Spans** mark stages of one request's lifecycle -- ``request``
    (submit -> finish/abort), ``admission_wait``, ``prefill``,
    ``compress``, ``kv_migration`` -- opened with ``span_begin`` and
    closed with ``span_end`` or ``span_abort``. Spans are keyed
    ``(rid, name)`` fleet-wide: a span opened on the prefill replica and
    closed on the decode replica (KV migration) is ONE span, so a
    disaggregated fleet still yields one contiguous trace per request.
  * **Instants** (``instant``) mark points: first token, prefill chunks,
    KV export/import, admission deferral.
  * **Slices** (``slice``) are duration events on a replica's engine /
    slot lanes -- one engine step, one decode-group launch.
  * **Counters** (``counter``) are sampled time series: KV watermark,
    admission queue depth, prefix-tier hits, migration bytes in flight.

Every event carries BOTH clocks: ``vt`` -- the engine's deterministic
virtual clock (what the cost model charges) -- and ``wt`` -- wall time
from ``time.perf_counter()`` (what the hardware actually took). Events
are plain dicts; ``None`` fields are omitted.

Zero overhead when off: the stack holds ``NULL_TRACER`` (class attr
``enabled = False``) by default and every instrumentation site is
guarded by ``if tracer.enabled:`` -- the disabled hot path performs no
calls, no allocation, no formatting. Tests enforce this by patching the
``NullTracer`` methods to raise.

The tracer doubles as the live span accounting the runtime sanitizer
checks (``open_requests(replica) == live rids`` at every pump
iteration) and the static O-rules lint (every ``span_begin`` must reach
a ``span_end``/``span_abort``; see the reference's ``repro.analysis.rules_obs``).

This module is import-light (stdlib only) so ``repro_torch.core`` can import
it without layering cycles; sinks (Perfetto export, JSONL streaming)
subscribe via ``add_sink``.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


class NullTracer:
    """The no-op tracer: every emit is a pass, ``enabled`` is False so
    guarded call sites skip even the call. A single shared instance
    (``NULL_TRACER``) serves every untraced engine/server."""

    enabled = False

    def span_begin(self, name, rid, **kw):
        pass

    def span_end(self, name, rid, **kw):
        pass

    def span_abort(self, rid, **kw):
        pass

    def instant(self, name, rid=None, **kw):
        pass

    def slice(self, name, vt0, dur, **kw):
        pass

    def counter(self, name, value, **kw):
        pass

    def open_requests(self, replica=None) -> Set[int]:
        return set()


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Collects lifecycle events (see module docstring).

    One instance is shared by every replica of a fleet (the Router wires
    it through ``LVLM.serve_cluster(obs=...)``), so span pairing and
    request ownership survive the prefill->decode migration boundary.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.events: List[Dict] = []
        self._clock = clock
        self._sinks: List[Callable[[Dict], None]] = []
        # open spans keyed (rid, name) -> begin event (span pairing);
        # request ownership rid -> replica (the sanitizer invariant and
        # the migration-boundary track assignment both read it)
        self._open: Dict[Tuple[int, str], Dict] = {}
        self._owner: Dict[int, int] = {}
        # per-rid virtual-time high-water mark over span boundary events.
        # Replica virtual clocks are NOT synchronized: an import on a
        # quiet decode replica can carry a lower clock than the source's
        # export. The request's OWN timeline must still be monotone
        # (validate checks it), so boundary events clamp to the furthest
        # virtual time the request has reached on any replica.
        self._vt_hwm: Dict[int, float] = {}

    # ------------------------------------------------------------ sinks --
    def add_sink(self, sink: Callable[[Dict], None]) -> None:
        """Subscribe a sink: called once per event dict as it is
        emitted (the streaming-JSONL path)."""
        self._sinks.append(sink)

    def _emit(self, ev: Dict) -> Dict:
        self.events.append(ev)
        for sink in self._sinks:
            sink(ev)
        return ev

    def _event(self, kind: str, name: str, rid=None, replica=None,
               slot=None, vt=None, dur=None, value=None,
               attrs=None) -> Dict:
        ev: Dict = {"k": kind, "name": name, "wt": self._clock()}
        if rid is not None:
            ev["rid"] = rid
        if replica is not None:
            ev["rep"] = replica
        if slot is not None:
            ev["slot"] = slot
        if vt is not None:
            ev["vt"] = vt
        if dur is not None:
            ev["dur"] = dur
        if value is not None:
            ev["value"] = value
        if attrs:
            ev["attrs"] = attrs
        return ev

    def _clamp_vt(self, rid: int, vt: float) -> float:
        vt = max(vt, self._vt_hwm.get(rid, vt))
        self._vt_hwm[rid] = vt
        return vt

    # ------------------------------------------------------------ spans --
    def span_begin(self, name: str, rid: int, *, replica: int = 0,
                   slot: Optional[int] = None, vt: float = 0.0,
                   **attrs) -> None:
        vt = self._clamp_vt(rid, vt)
        key = (rid, name)
        if key in self._open:
            # double-begin (e.g. re-submit of a rid whose span leaked):
            # close the stale one as aborted so the trace stays paired
            self.span_abort(rid, replica=replica, vt=vt,
                            reason=f"re-begin of open span {name!r}")
        ev = self._emit(self._event("B", name, rid=rid, replica=replica,
                                    slot=slot, vt=vt,
                                    attrs=attrs or None))
        self._open[key] = ev
        if name == "request":
            self._owner[rid] = replica

    def span_end(self, name: str, rid: int, *, replica: int = 0,
                 slot: Optional[int] = None, vt: float = 0.0,
                 **attrs) -> None:
        vt = self._clamp_vt(rid, vt)
        self._open.pop((rid, name), None)
        if name == "request":
            self._owner.pop(rid, None)
        elif name == "kv_migration" and rid in self._owner:
            # the import side closes the migration span: ownership of the
            # request track moves to the importing replica
            self._owner[rid] = replica
        self._emit(self._event("E", name, rid=rid, replica=replica,
                               slot=slot, vt=vt, attrs=attrs or None))

    def span_abort(self, rid: int, *, replica: int = 0, vt: float = 0.0,
                   reason: str = "abort", **attrs) -> None:
        """Close EVERY open span of ``rid`` (innermost first) with an
        abort marker -- the single call the abort/failure paths make so
        no span is ever orphaned by a cancellation, disconnect timeout,
        or pump death."""
        vt = self._clamp_vt(rid, vt)
        keys = [k for k in reversed(list(self._open)) if k[0] == rid]
        for key in keys:
            del self._open[key]
            self._emit(self._event(
                "E", key[1], rid=rid, replica=replica, vt=vt,
                attrs=dict(attrs, aborted=True, reason=reason)))
        self._owner.pop(rid, None)

    # --------------------------------------------------- points & series --
    def instant(self, name: str, rid: Optional[int] = None, *,
                replica: int = 0, slot: Optional[int] = None,
                vt: float = 0.0, **attrs) -> None:
        self._emit(self._event("i", name, rid=rid, replica=replica,
                               slot=slot, vt=vt, attrs=attrs or None))

    def slice(self, name: str, vt0: float, dur: float, *,
              replica: int = 0, slot: Optional[int] = None,
              rid: Optional[int] = None, **attrs) -> None:
        """A duration event on a replica lane (engine lane when ``slot``
        is None, else that slot's lane): virtual start ``vt0``, virtual
        duration ``dur``."""
        self._emit(self._event("X", name, rid=rid, replica=replica,
                               slot=slot, vt=vt0, dur=dur,
                               attrs=attrs or None))

    def counter(self, name: str, value: float, *, replica: int = 0,
                vt: float = 0.0) -> None:
        self._emit(self._event("C", name, replica=replica, vt=vt,
                               value=value))

    # ------------------------------------------------------- accounting --
    def open_requests(self, replica: Optional[int] = None) -> Set[int]:
        """rids with an open ``request`` span (optionally only those
        owned by ``replica``) -- the sanitizer invariant's left side."""
        if replica is None:
            return set(self._owner)
        return {rid for rid, rep in self._owner.items() if rep == replica}

    def open_spans(self) -> List[Tuple[int, str]]:
        return list(self._open)

    # ----------------------------------------------------------- export --
    def write_jsonl(self, path: str) -> int:
        """Dump the in-memory event log as one JSON object per line
        (one event per line, as ``load_trace`` reads it). Returns event count."""
        with open(path, "w", encoding="utf-8") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return len(self.events)


class JsonlSink:
    """Streaming sink: every event appends one JSON line as it happens
    (crash-durable, unlike the post-hoc ``write_jsonl``)."""

    def __init__(self, path: str):
        self._f = open(path, "w", encoding="utf-8")

    def __call__(self, ev: Dict) -> None:
        self._f.write(json.dumps(ev) + "\n")

    def close(self) -> None:
        self._f.close()
