"""Admission control for the async serving layer: KV watermarks with
hysteresis and FIFO backpressure.

Port of ``repro.serving.admission`` (same watermarks, same order).

The engine's dense slot pool (and any narrower ``kv_capacity_tokens``
budget) is a hard resource: vLLM-style serving systems gate request entry
on free KV blocks so a burst degrades into queueing delay, never into an
allocator crash. Here the pressure signal is
``Engine.kv_committed_tokens()`` -- the block-rounded reservation
(prompt + max_new + decode lookahead, speculative ``gamma`` included) of
every live request -- measured against ``Engine.kv_capacity_tokens``:

  * a submit that keeps usage at or below ``high_watermark`` is admitted
    immediately (``Engine.submit`` runs synchronously, FIFO with any
    earlier waiters);
  * otherwise the caller AWAITS in a FIFO queue. Waiters drain only once
    usage falls back to ``low_watermark`` (hysteresis, so admission does
    not thrash around the boundary), each re-checked against the high
    watermark as it is admitted;
  * ``max_inflight`` optionally bounds the number of live requests inside
    the engine (waiting + running) regardless of KV headroom.

The deferred queue drains FIFO by default. ``order="slack"`` switches it
to SLO-slack order: waiters are admitted earliest-deadline-first (each
request's TTFT deadline minus the fleet's expected TTFT -- the serving
layer installs the key via ``AdmissionController.order_key``). EDF over
fixed per-request deadlines is starvation-free: a parked request's
deadline never moves while every NEW arrival's deadline recedes, so the
parked one eventually sorts first -- and the drain loop never admits past
a waiter that does not fit, so sorting first guarantees admission next.

The controller is event-loop-confined like the rest of the serving layer:
no locks, admission decisions interleave only at awaits.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
from typing import Callable, Deque, List, Optional, Tuple


@dataclasses.dataclass
class AdmissionConfig:
    """Watermarks are fractions of ``Engine.kv_capacity_tokens``."""
    high_watermark: float = 0.9
    low_watermark: float = 0.7
    max_inflight: Optional[int] = None     # live requests in the engine
    order: str = "fifo"                    # deferred-queue order: fifo|slack

    def __post_init__(self):
        if not 0.0 < self.high_watermark <= 1.0:
            raise ValueError("high_watermark must be in (0, 1]")
        if not 0.0 < self.low_watermark <= self.high_watermark:
            raise ValueError("low_watermark must be in (0, high_watermark]")
        if self.order not in ("fifo", "slack"):
            raise ValueError("order must be 'fifo' or 'slack'")


class AdmissionController:
    """Gates ``Engine.submit`` behind KV watermarks (see module docstring).

    ``admit`` is the only await point; ``maybe_admit`` is the drain hook
    the server pump calls after every step and abort.
    """

    def __init__(self, cfg: AdmissionConfig, engine):
        self.cfg = cfg
        self.engine = engine
        # (future, request, kv need, commit callable) -- the commit is
        # what admission runs once the request fits: Engine.submit for a
        # fresh request, Engine.import_kv for a migrated-in one
        self._waiters: Deque[Tuple[asyncio.Future, object, int, Callable]] \
            = collections.deque()
        self._draining = False          # blocked until usage <= low mark
        self.admitted = 0
        self.deferrals = 0              # submits that had to wait
        # deferred-queue ordering hook: None = strict FIFO; otherwise a
        # key(request) callable -- waiters drain smallest-key-first (the
        # serving layer installs an SLO-slack key for order="slack")
        self.order_key: Optional[Callable[[object], float]] = None

    # ------------------------------------------------------------ state --
    def _live(self) -> int:
        eng = self.engine
        return (len([r for r in eng.waiting if not r.aborted])
                + len([r for r in eng.running if not r.aborted]))

    def _fits(self, need: int) -> bool:
        cfg, eng = self.cfg, self.engine
        if cfg.max_inflight is not None and self._live() >= cfg.max_inflight:
            return False
        return (eng.kv_committed_tokens() + need
                <= cfg.high_watermark * eng.kv_capacity_tokens)

    def _can_admit(self, need: int) -> bool:
        eng = self.engine
        if not (eng.waiting or eng.running):
            return True      # empty engine: a lone request always progresses
        return self._fits(need)

    @property
    def queue_depth(self) -> int:
        return len(self._waiters)

    @property
    def draining(self) -> bool:
        """Hysteresis state: True while admits are held until committed
        usage falls back to the low watermark (exported as the
        ``repro_admission_draining`` gauge; a controller pressure
        signal)."""
        return self._draining

    def refresh(self, req) -> bool:
        """Recompute a DEFERRED waiter's stored KV need after something
        rewrote the request's shape (the adaptive controller swapping
        ``req.compression`` to an aggressive preset). Without this the
        queue would keep gating on the pre-rewrite token count and a
        shrunken request could wait on KV it no longer needs. Returns
        True if ``req`` was found in the queue."""
        for i, entry in enumerate(self._waiters):
            if entry[1] is req:
                fut, r, _stale, submit = entry
                self._waiters[i] = (fut, r,
                                    self.engine.kv_request_tokens(r),
                                    submit)
                return True
        return False

    # ------------------------------------------------------------- gate --
    async def admit(self, req, submit: Optional[Callable] = None) -> bool:
        """Commit ``req`` into the engine, awaiting under backpressure.

        ``submit`` is the commit callable gated by the watermarks --
        ``Engine.submit`` by default; the serving layer passes
        ``Engine.import_kv`` (bound to a migration ticket) for a
        migrated-in request so KV imports respect the same pressure
        limits as fresh admissions.

        Returns True once the commit has run, False if the waiter was
        retracted via ``cancel`` (the request never entered the engine).
        Oversized single requests (which can NEVER fit a slot) still
        raise ``ValueError`` from the engine -- backpressure is for
        aggregate pool pressure, not impossible requests.
        """
        if submit is None:
            submit = self.engine.submit
        need = self.engine.kv_request_tokens(req)
        if not (self.engine.waiting or self.engine.running):
            self._draining = False      # idle engine: hysteresis is stale
        if not self._waiters and not self._draining and self._can_admit(need):
            submit(req)
            self.admitted += 1
            return True
        self.deferrals += 1
        self._draining = True
        req._gate_clock = self.engine.clock   # deadline anchor for slack
        fut = asyncio.get_running_loop().create_future()
        entry = (fut, req, need, submit)
        self._waiters.append(entry)
        try:
            # maybe_admit() submits before resolving True; cancel()
            # retracts the entry and resolves False
            return await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled() \
                    and fut.exception() is None and fut.result():
                # admitted between cancellation and wakeup: undo
                self.engine.abort(req.rid)
            else:
                try:
                    # analysis: atomic-step (removes only this coroutine's
                    # own entry; no other waiter state is read or assumed
                    # to be unchanged across the await)
                    self._waiters.remove(entry)
                except ValueError:
                    pass
            raise

    def cancel(self, req) -> bool:
        """Retract a queued waiter (its stream was cancelled before
        admission). The awaiting ``admit`` returns False; the request
        never reaches ``Engine.submit``."""
        for entry in list(self._waiters):
            fut, r = entry[0], entry[1]
            if r is req:
                self._waiters.remove(entry)
                if not fut.done():
                    fut.set_result(False)
                self._draining = bool(self._waiters)
                return True
        return False

    def _drain_order(self) -> List[Tuple[asyncio.Future, object, int,
                                         Callable]]:
        """Waiters in admission order: FIFO, or smallest ``order_key``
        first (stable, so equal-slack waiters keep arrival order)."""
        if self.order_key is None:
            return list(self._waiters)
        return sorted(self._waiters, key=lambda e: self.order_key(e[1]))

    def maybe_admit(self) -> int:
        """Drain waiters when usage is back under the low watermark.
        Called by the pump after every engine step / abort. Returns the
        number of requests admitted. Never admits PAST a waiter that does
        not fit (no bypass), so the head of the drain order -- FIFO or
        earliest slack -- is always the next admitted: starvation-free."""
        if not self._waiters:
            self._draining = False
            return 0
        eng = self.engine
        if (eng.kv_committed_tokens()
                > self.cfg.low_watermark * eng.kv_capacity_tokens):
            return 0
        n = 0
        for entry in self._drain_order():
            fut, req, need, submit = entry
            if fut.cancelled():
                self._waiters.remove(entry)
                continue
            if not self._can_admit(need):
                break
            self._waiters.remove(entry)
            try:
                submit(req)        # commit BEFORE resolving: accounting is
            except Exception as exc:   # impossible request (can never fit
                # a slot): surface to ITS caller, exactly like the
                # fast-path submit would -- never into the pump, which
                # calls this drain and must not die for one bad request
                if not fut.done():
                    fut.set_exception(exc)
                continue
            self.admitted += 1     # correct even if the waiter runs late
            fut.set_result(True)
            n += 1
        self._draining = bool(self._waiters)
        return n

    def cancel_waiters(self) -> None:
        """Fail every pending waiter (server shutdown without drain)."""
        while self._waiters:
            fut = self._waiters.popleft()[0]
            if not fut.done():
                fut.set_exception(
                    RuntimeError("server stopped before admission"))
        self._draining = False
