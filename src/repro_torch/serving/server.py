"""``AsyncLVLMServer``: the asyncio pump over the grouped Engine.

Port of ``repro.serving.server``. One background task drives
``Engine.step()`` -- each step one iteration over the whole slot pool,
decode slots grouped per request strategy -- and fans newly emitted
tokens out to per-request ``TokenStream`` queues. Clients are plain
coroutines:

    server = lvlm.serve_async(EngineConfig(max_batch=8, cache_len=256))
    async with server:
        stream = server.submit(Request(rid=0, tokens=prompt,
                                       decoder="speculative"))
        async for tok in stream:          # tokens as the engine emits them
            ...
            if bored:
                stream.cancel()           # frees slot + draft row + pins
                break

Design points:

  * Everything is event-loop-confined: submits, aborts, and the pump
    interleave only at awaits, so there are no locks and the engine is
    never re-entered. ``Engine.step()`` runs synchronously inside the
    loop and blocks it for one step (on CUDA until sampling's host read
    of the tokens) -- by design: the card is the serial resource, and
    CUDA's current device and stream are per thread, so the engine stays
    on the loop's thread; asyncio buys request multiplexing, streaming
    delivery, and backpressure.
  * Admission runs lazily on the stream's FIRST ``__anext__`` (i.e. when
    the client starts consuming), so ``submit`` itself never blocks;
    under KV pressure the client awaits inside the admission gate instead
    of the engine crashing.
  * Determinism: the engine's virtual clock and temperature-0 decoding
    make the async path bit-identical to the sync facade
    (``tests/test_torch_serving.py`` holds it against the reference).
  * Pacing: ``pacing="virtual"`` (default) runs steps back-to-back and
    time exists only on the engine's virtual clock -- deterministic, the
    mode every test uses. ``pacing="wall"`` sleeps each step's virtual
    duration (scaled by ``pacing_scale``) in REAL time.
  * Disconnects: with ``disconnect_timeout_s`` set, a stream whose
    consumer stopped reading (emitted tokens sitting unread for longer
    than the timeout, in WALL seconds, measured between pump-iteration
    checks, so loop-blocking step time never counts against it) is
    treated as hung up -- the request is aborted and every held resource
    (KV slot, draft row, gamma lookahead, prefix pin) is released.
  * ``stop()`` drains by default (finishes in-flight work); pass
    ``drain=False`` to abort all live streams first.
  * Migration: a request parked in ``MIGRATING`` (a disaggregated
    handoff after prefill, or a drain) surfaces as a ``MigrateSignal`` on
    its stream; the fronting ``repro_torch.cluster.Router`` runs the
    protocol (``Engine.export_kv`` -> a sibling's ``import_stream`` ->
    ``complete_export`` + ``release_migrated``) from the consumer task.
  * ``control=``: an SLO-adaptive ``repro_torch.control.Controller``
    shapes admissions and walks its ladder once per pump iteration;
    ``None`` makes zero policy calls.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from repro_torch.analysis.sanitizer import (assert_conserved,
                                            check_server_conservation)
from repro_torch.core.serving.request import Request, State
from repro_torch.obs.profile import profile_families
from repro_torch.obs.prom import (PromText, engine_families,
                                  registry_families)
from repro_torch.serving.admission import (AdmissionConfig,
                                           AdmissionController)
from repro_torch.serving.metrics import MetricsRegistry

_DONE = object()                      # stream sentinel


class MigrateSignal(Exception):
    """Pushed into a stream's queue when its request parks in MIGRATING
    (disaggregated handoff after prefill, or a drain's live migration).
    The consumer-side Router catches it and runs the migration protocol
    -- export, import on a sibling, source release -- from the consumer
    task, so the pump never blocks on a sibling server. Seeing it raised
    from a bare ``TokenStream`` means a migration was requested on a
    server with no fronting ``repro_torch.cluster.Router``."""

    def __init__(self, rid: int):
        super().__init__(f"request {rid} awaiting KV migration")
        self.rid = rid


class TokenStream:
    """One request's async token channel (single consumer).

    ``async for tok in stream`` yields token ids as the engine emits them
    (speculative rounds surface several per step). ``cancel()`` aborts
    the request mid-stream; tokens already emitted remain readable, then
    the iterator ends.
    """

    def __init__(self, server: "AsyncLVLMServer", request: Request):
        self._server = server
        self.request = request
        self._q: asyncio.Queue = asyncio.Queue()
        self._pushed = 0              # tokens fanned out so far
        self._submitted = False
        self._finished = False
        self.aborted = False
        self.disconnected = False     # aborted by the disconnect timeout
        self.submit_clock: Optional[float] = None
        self.admit_clock: Optional[float] = None
        self._migrate_signaled = False   # MigrateSignal already queued
        # wall-clock consumer liveness (disconnect-timeout bookkeeping)
        self._reading = False         # consumer currently inside __anext__
        self._pending_since = None    # first post-step sighting of an
        #                               unread backlog (None = no backlog)

    @property
    def queue_wait(self) -> float:
        """Virtual-clock admission-gate wait (0 until admitted)."""
        if self.submit_clock is None or self.admit_clock is None:
            return 0.0
        return self.admit_clock - self.submit_clock

    @property
    def tokens(self) -> List[int]:
        """Tokens generated so far (complete once the stream ends)."""
        return list(self.request.generated)

    def cancel(self) -> bool:
        """Abort mid-stream; see ``AsyncLVLMServer.abort``."""
        return self._server.abort(self.request.rid)

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        self._reading = True            # an awaiting consumer is NOT hung up
        try:
            if not self._submitted and not self._finished:
                await self._server._admit(self)
            if self._finished and self._q.empty():
                raise StopAsyncIteration
            item = await self._q.get()
        finally:
            self._reading = False
            self._pending_since = None  # the consumer is keeping up
        if item is _DONE:
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            raise item                  # pump failure propagates, no hang
        return item


class AsyncLVLMServer:
    """Async streaming server over one Engine (see module docstring).

    Build via ``LVLM.serve_async(engine_cfg, gen=..., draft=...,
    admission=...)``; the engine wiring (decoder registry, compression,
    temperature plumbing) is exactly ``LVLM.serve``'s.
    """

    def __init__(self, lvlm, *, engine_cfg=None, gen=None, draft=None,
                 admission: Optional[AdmissionConfig] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 compressors: Optional[Dict] = None,
                 pacing: str = "virtual", pacing_scale: float = 1.0,
                 disconnect_timeout_s: Optional[float] = None,
                 tracer=None, profiler=None, control=None):
        if pacing not in ("virtual", "wall"):
            raise ValueError("pacing must be 'virtual' or 'wall'")
        self.engine = lvlm._serve_engine(engine_cfg, gen, draft,
                                         compressors=compressors,
                                         tracer=tracer, profiler=profiler)
        # the server shares the engine's tracer and profiler (the null
        # objects when off): admission-gate spans and pump counter tracks
        # are emitted here, site histograms surface in metrics_snapshot()
        self.tracer = self.engine.tracer
        self.profiler = self.engine.profiler
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.admission = AdmissionController(
            admission if admission is not None else AdmissionConfig(),
            self.engine)
        if self.admission.cfg.order == "slack":
            self.admission.order_key = self._slack
        self.pacing = pacing
        self.pacing_scale = pacing_scale
        self.disconnect_timeout_s = disconnect_timeout_s
        self.disconnects = 0
        # callback(rid) fired after ANY successful abort (disconnect
        # timeouts fire inside the pump)
        self.on_abort = None
        self._streams: Dict[int, TokenStream] = {}
        self._wake: Optional[asyncio.Event] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._stopping = False
        self._pump_error: Optional[BaseException] = None
        # SLO-adaptive controller (repro_torch.control), possibly shared
        # fleet-wide like the tracer/profiler. None = zero policy calls:
        # every call site below guards on `is not None`, same discipline
        # as tracer.enabled
        self.control = control
        if control is not None:
            control.attach(self)
        # runtime sanitizer: follows the engine's resolved flag
        # (EngineConfig.sanitize / REPRO_SANITIZE)
        self.sanitize = bool(getattr(self.engine, "sanitize", False))

    def _sanitize_check(self) -> None:
        assert_conserved(self, check_server_conservation,
                         "AsyncLVLMServer pump step")

    def _slack(self, req: Request) -> float:
        """SLO slack of a deferred request: its TTFT deadline (anchored at
        the later of arrival and the clock when it was parked) minus now
        and minus the live expected TTFT. The clock and expected-TTFT
        terms are uniform across the waiters of one drain, so the ORDER
        is earliest-deadline-first, which is starvation-free."""
        anchor = max(req.arrival, getattr(req, "_gate_clock", 0.0))
        deadline = anchor + req.slo.ttft_ms * 1e-3
        return deadline - self.engine.clock - self.metrics.expected_ttft()

    # -------------------------------------------------------- lifecycle --
    async def start(self) -> "AsyncLVLMServer":
        if self._pump_task is None:
            self._stopping = False
            self._wake = asyncio.Event()
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop the pump. ``drain=True`` finishes in-flight requests
        first; ``drain=False`` aborts every live stream immediately."""
        if self._pump_task is None:
            return
        if not drain:
            self.admission.cancel_waiters()
            for rid in list(self._streams):
                self.abort(rid)
        self._stopping = True
        self._wake.set()
        try:
            await self._pump_task      # re-raises a pump failure here
        finally:
            self._pump_task = None

    async def __aenter__(self) -> "AsyncLVLMServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=not any(exc))

    # ----------------------------------------------------------- intake --
    def submit(self, request: Request) -> TokenStream:
        """Register a request and return its token stream. Admission (and
        hence any backpressure await) happens on the stream's first
        ``__anext__`` -- ``submit`` itself never blocks. The rid is
        reserved immediately, so a duplicate submit fails fast and a
        ``cancel()`` BEFORE the first ``__anext__`` already aborts."""
        if request.rid in self._streams:
            raise ValueError(f"request id {request.rid} already streaming")
        stream = TokenStream(self, request)
        self._streams[request.rid] = stream
        return stream

    async def _admit(self, stream: TokenStream) -> None:
        if self._pump_error is not None:
            raise RuntimeError("server pump failed") from self._pump_error
        if self._pump_task is None:
            await self.start()          # lazy start outside `async with`
        stream._submitted = True
        stream.submit_clock = self.engine.clock
        rid = stream.request.rid
        rep = self.engine.trace_replica
        if self.tracer.enabled:
            self.tracer.span_begin("admission_wait", rid, replica=rep,
                                   vt=self.engine.clock)
        if self.control is not None:
            # under pressure: degrade the incoming request's shape BEFORE
            # the watermark check (aggressive preset = smaller KV need)
            self.control.shape(self, stream.request)
        try:
            admitted = await self.admission.admit(stream.request)
        except asyncio.CancelledError:
            self._streams.pop(stream.request.rid, None)
            if self.control is not None:
                self.control.revert(stream.request)
            stream.aborted = True
            stream._finished = True
            if self.tracer.enabled:
                self.tracer.span_abort(rid, replica=rep,
                                       vt=self.engine.clock,
                                       reason="cancelled at admission")
            raise
        if not admitted:
            if self.control is not None:
                self.control.revert(stream.request)
            if self.tracer.enabled:
                self.tracer.span_end("admission_wait", rid, replica=rep,
                                     vt=self.engine.clock, cancelled=True)
            return                      # cancelled at the admission gate
        if self.control is not None:
            # the request entered the engine under its (possibly
            # degraded) fields: consume the override record
            self.control.commit(stream.request)
        stream.admit_clock = self.engine.clock
        if self.tracer.enabled:
            self.tracer.span_end("admission_wait", rid, replica=rep,
                                 vt=self.engine.clock)
        self._wake.set()

    def abort(self, rid: int) -> bool:
        """Cancel a live request: ``Engine.abort`` frees its KV slot, any
        speculative draft-pool slot, the reserved lookahead, and its
        prefix pin; already-emitted tokens stay readable on the stream.
        Works at every lifecycle stage: not-yet-iterated, waiting at the
        admission gate, or mid-decode."""
        stream = self._streams.pop(rid, None)
        ok = self.engine.abort(rid)
        if stream is not None:
            if not ok and stream._submitted:
                # parked at the admission gate: retract the waiter so the
                # cancelled request never enters the engine
                self.admission.cancel(stream.request)
            stream.aborted = True
            stream.request.aborted = True
            self._fan_out(stream)
            self._finish_stream(stream, aborted=True)
        self.admission.maybe_admit()     # freed capacity -> drain waiters
        aborted = ok or stream is not None
        if aborted and self.on_abort is not None:
            self.on_abort(rid)
        return aborted

    # -------------------------------------------------------- migration --
    def request_migration(self, rid: int) -> bool:
        """Ask for ``rid`` to be migrated off this server. An exportable
        DECODE-phase request parks in MIGRATING now (the pump then pushes
        a ``MigrateSignal`` to its consumer); a request still waiting,
        prefilling, or parked at the admission gate is flagged ``handoff``
        so it parks right after its prefill. Returns False when the
        request is unknown, finished, or not exportable -- it then simply
        finishes here."""
        eng = self.engine
        for r in eng.running:
            if r.rid == rid and r.state is State.DECODE:
                if not eng.can_export(r):
                    return False
                r.state = State.MIGRATING
                if self._wake is not None:
                    self._wake.set()
                return True
        for r in list(eng.waiting) + [x for x in eng.running
                                      if x.state is State.PREFILL]:
            if r.rid == rid and r.state is not State.DONE:
                if not eng.can_export(r):
                    return False
                r.handoff = True
                if self._wake is not None:
                    self._wake.set()
                return True
        stream = self._streams.get(rid)
        if stream is not None and not stream.aborted \
                and stream.request.state is State.WAITING:
            # parked at the admission gate: prefill will park it for
            # export once admitted
            if not eng.can_export(stream.request):
                return False
            stream.request.handoff = True
            return True
        return False

    async def import_stream(self, request: Request, ticket: Dict, *,
                            ready_at: float = 0.0) -> TokenStream:
        """Adopt a request migrated FROM a sibling server: register its
        stream (tokens the source already delivered are not replayed) and
        commit the KV import through the admission gate, so migrated KV
        respects the same watermarks as fresh admissions. On any failure
        (no free slot, cancelled, pump dead) nothing stays registered and
        the caller still holds the source's export pin."""
        if self._pump_error is not None:
            raise RuntimeError("server pump failed") from self._pump_error
        rid = request.rid
        if self._pump_task is None:
            await self.start()
        if rid in self._streams:
            raise ValueError(f"request id {rid} already streaming")
        stream = TokenStream(self, request)
        stream._submitted = True
        stream._pushed = len(request.generated)  # source already delivered
        stream.submit_clock = self.engine.clock
        # full-decode KV accounting from the first watermark check on: the
        # request decodes HERE even though its prefill ran elsewhere
        request._imported = True
        # the stream registers BEFORE the admission await so the
        # sanitizer's live-rid/stream invariant holds the moment the
        # import commits inside the gate
        # analysis: atomic-step (the duplicate-rid check runs AFTER the
        # lazy start() suspension, with no await between it and this
        # registration)
        self._streams[rid] = stream
        rep = self.engine.trace_replica
        if self.tracer.enabled:
            # the import waits out the same watermarks as a fresh
            # admission; on failure ONLY this span closes -- the request
            # (and its open kv_migration span) stays live on the source,
            # which resumes it via cancel_export or tries a sibling
            self.tracer.span_begin("admission_wait", rid, replica=rep,
                                   vt=self.engine.clock, imported=True)
        try:
            admitted = await self.admission.admit(
                request,
                submit=lambda r: self.engine.import_kv(r, ticket,
                                                       ready_at=ready_at))
        except BaseException:
            # analysis: atomic-step (retracts only this coroutine's own
            # registration; no other stream state is assumed unchanged
            # across the await)
            self._streams.pop(rid, None)
            stream._finished = True
            if self.tracer.enabled:
                self.tracer.span_end("admission_wait", rid, replica=rep,
                                     vt=self.engine.clock, failed=True)
            raise
        if not admitted:
            # analysis: atomic-step (same single-entry retraction as the
            # failure path above)
            self._streams.pop(rid, None)
            stream._finished = True
            if self.tracer.enabled:
                self.tracer.span_end("admission_wait", rid, replica=rep,
                                     vt=self.engine.clock, failed=True)
            raise RuntimeError(
                f"import of rid {rid} retracted at the admission gate")
        stream.admit_clock = self.engine.clock
        if self.tracer.enabled:
            self.tracer.span_end("admission_wait", rid, replica=rep,
                                 vt=self.engine.clock)
        self._wake.set()
        return stream

    def complete_export(self, rid: int) -> None:
        """Source-side release after a sibling committed the import (see
        ``Engine.complete_export``); wakes the pump so a now-unblocked
        drain can finish."""
        self.engine.complete_export(rid)
        self.admission.maybe_admit()     # freed KV -> drain waiters
        if self._wake is not None:
            self._wake.set()

    def cancel_export(self, rid: int) -> None:
        """Back out a migration: the request resumes decoding here."""
        self.engine.cancel_export(rid)
        stream = self._streams.get(rid)
        if stream is not None:
            stream._migrate_signaled = False   # a later drain may retry
        if self._wake is not None:
            self._wake.set()

    def release_migrated(self, rid: int) -> None:
        """Deregister the stream of a request migrated AWAY. No metrics
        record here -- the importing server observes the completed
        request, so fleet-merged registries count it exactly once."""
        stream = self._streams.pop(rid, None)
        if stream is not None:
            stream._finished = True

    # ------------------------------------------------------------- pump --
    async def _pump(self) -> None:
        eng = self.engine
        try:
            while True:
                before = eng.clock
                progressed = False
                if eng.waiting or eng.running:
                    # one grouped iteration, synchronously on this loop's
                    # thread (the CUDA stream state is per thread)
                    progressed = eng.step()
                self._drain()
                self._check_disconnects()
                self.admission.maybe_admit()
                if self.control is not None:
                    # observe pressure, walk the degradation ladder,
                    # reshape deferred waiters on a level change
                    self.control.on_step(self)
                if progressed and self.tracer.enabled:
                    self._emit_counters()
                if self.sanitize:
                    self._sanitize_check()   # conservation at the boundary
                if not progressed:
                    # idle, or every live request is frozen (MIGRATING /
                    # awaiting its KV transfer): park until a submit,
                    # migration completion, or stop wakes the pump --
                    # never busy-spin
                    if self._stopping:
                        return
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                if self.pacing == "wall":
                    # sleep the step's virtual duration in real time,
                    # scaled; clients consume during the sleep
                    await asyncio.sleep(
                        max(0.0, (eng.clock - before) * self.pacing_scale))
                else:
                    await asyncio.sleep(0)   # let clients consume this step
        except BaseException as exc:     # fail streams: never hang clients
            self._fail(exc)
            raise

    def _emit_counters(self) -> None:
        """Post-step counter tracks: KV watermark, admission queue depth,
        prefix hits (local + cluster tier), migration bytes in flight --
        the live time-series the SLO-adaptive controller reads and the
        Perfetto export renders as counter lanes."""
        eng = self.engine
        rep = eng.trace_replica
        vt = eng.clock
        t = self.tracer
        t.counter("kv_committed_tokens", eng.kv_committed_tokens(),
                  replica=rep, vt=vt)
        t.counter("admission_queue_depth", len(self.admission._waiters),
                  replica=rep, vt=vt)
        t.counter("prefix_hit_tokens", eng.prefix_hit_tokens,
                  replica=rep, vt=vt)
        if eng.prefix_share is not None:
            stats = eng.prefix_share.stats()
            t.counter("prefix_tier_hits", stats.get("hits", 0),
                      replica=rep, vt=vt)
        t.counter("migration_bytes_inflight",
                  eng._export_bytes_inflight(), replica=rep, vt=vt)

    def _check_disconnects(self) -> None:
        """Abort streams whose consumer hung up: tokens stayed queued
        unread with no ``__anext__`` awaiting for more than
        ``disconnect_timeout_s`` WALL seconds. Backlog age is anchored at
        the first POST-step sighting (this method runs right after each
        step) and every read clears it, so time the event loop spent
        blocked inside a step never counts against the consumer. The
        abort releases the slot / draft row / gamma lookahead / prefix
        pin exactly like an explicit ``cancel()``."""
        if self.disconnect_timeout_s is None or not self._streams:
            return
        now = asyncio.get_running_loop().time()
        for rid, stream in list(self._streams.items()):
            if stream._reading or stream._q.empty():
                stream._pending_since = None   # consuming / nothing unread
                continue
            if stream._pending_since is None:
                stream._pending_since = now    # backlog first seen NOW
                continue
            if now - stream._pending_since > self.disconnect_timeout_s:
                stream.disconnected = True
                self.disconnects += 1
                self.abort(rid)

    def _fail(self, exc: BaseException) -> None:
        """Pump died: every live stream and admission waiter must learn,
        or their consumers would await a sentinel that never comes."""
        self._pump_error = exc
        self.admission.cancel_waiters()
        for rid, stream in list(self._streams.items()):
            del self._streams[rid]
            self._fan_out(stream)
            stream._finished = True
            stream._q.put_nowait(exc)
            if self.tracer.enabled:
                # close every span the dead server still holds open
                self.tracer.span_abort(rid,
                                       replica=self.engine.trace_replica,
                                       vt=self.engine.clock,
                                       reason="pump failure")

    def _fan_out(self, stream: TokenStream) -> None:
        gen = stream.request.generated
        while stream._pushed < len(gen):
            stream._q.put_nowait(gen[stream._pushed])
            stream._pushed += 1

    def _finish_stream(self, stream: TokenStream, aborted: bool) -> None:
        stream._finished = True
        stream._q.put_nowait(_DONE)
        req = stream.request
        name = req.decoder or self.engine._default_name
        self.metrics.observe(req, queue_wait=stream.queue_wait,
                             decoder=name, aborted=aborted)

    def _drain(self) -> None:
        """Fan each stream's new tokens out, finish the done ones (the
        ``server.fan_out`` profiler site)."""
        if self.profiler.enabled:
            self.profiler.site_begin("server.fan_out")
        for rid, stream in list(self._streams.items()):
            self._fan_out(stream)
            if stream.request.state is State.DONE:
                del self._streams[rid]
                self._finish_stream(stream, aborted=False)
            elif (stream.request.state is State.MIGRATING
                  and not stream._migrate_signaled):
                # tell the consumer -- after any tokens already fanned out
                # -- to run the migration protocol from its own task
                stream._migrate_signaled = True
                stream._q.put_nowait(MigrateSignal(rid))
        if self.profiler.enabled:
            self.profiler.site_end("server.fan_out")

    # ---------------------------------------------------------- reports --
    def metrics_snapshot(self, *, replica: Optional[int] = None) -> str:
        """Pull-based metrics snapshot in Prometheus text exposition
        format: request-latency summaries (exact quantiles over the
        registry's records), live engine gauges (KV watermark, pool
        occupancy, virtual clock), and admission counters. ``replica``
        adds a ``replica="i"`` label to every family."""
        prom = PromText()
        labels = ({"replica": str(replica)}
                  if replica is not None else None)
        registry_families(prom, self.metrics.records, labels=labels)
        engine_families(prom, self.engine, labels=labels)
        prom.counter("admitted_total", "Requests admitted.",
                     self.admission.admitted, labels=labels)
        prom.counter("deferred_total",
                     "Requests deferred at the admission gate.",
                     self.admission.deferrals, labels=labels)
        prom.gauge("admission_queue_depth",
                   "Requests parked at the admission gate.",
                   len(self.admission._waiters), labels=labels)
        prom.gauge("admission_draining",
                   "1 while the admission gate holds admits until "
                   "committed KV falls to the low watermark.",
                   int(self.admission.draining), labels=labels)
        prom.counter("disconnects_total",
                     "Streams aborted by the disconnect timeout.",
                     self.disconnects, labels=labels)
        # standalone server: render the profiler's hot-path site
        # histograms here; in a fleet the profiler is shared, so the
        # Router renders them ONCE at fleet level (replica label absent)
        if replica is None and self.profiler.enabled:
            profile_families(prom, self.profiler)
        # same sharing rule for the adaptive controller's families
        if replica is None and self.control is not None:
            self.control.prom_families(prom)
        return prom.render()

    def summary(self) -> Dict:
        """Metrics summary + admission counters (see MetricsRegistry)."""
        out = self.metrics.summary(self.engine)
        out["admitted"] = self.admission.admitted
        out["deferred"] = self.admission.deferrals
        out["disconnects"] = self.disconnects
        out.update({f"decoder_stats/{k}": v
                    for k, v in self.engine.decoder_stats().items()
                    if not isinstance(v, (list, dict))})
        # per-compression-strategy prefill token reduction (dim 1)
        for name, cs in self.engine.compression_stats().items():
            for k, v in cs.items():
                out[f"compression/{name}/{k}"] = v
        if self.control is not None:
            out.update(self.control.summary())
        return out
