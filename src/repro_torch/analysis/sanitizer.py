"""Runtime sanitizer: conservation asserts at engine/server step
boundaries -- the dynamic half of the R-rules.

Port of ``repro.analysis.sanitizer`` (its own copy: the port imports no
module of ``repro``). It reads the port engine's ``slot_req``,
``slot_pos``, ``_prefix_pins``, ``_prefix``, each request's
``_prefix_pin``, each decoder's ``bound_slots`` and the export tickets
of live KV migrations (``_exports``), whose pins and slots the laws
below account for while a migration is in flight.

The static R-rules prove release sites EXIST on every path; the
sanitizer proves the accounting actually balances while the system
runs, so a static finding can be confirmed (the assert trips) or waived
(it never does) with evidence. Enabled via ``EngineConfig.sanitize`` or
``REPRO_SANITIZE=1`` (CI's smoke job runs the whole suite with it on).

Invariants checked after every ``Engine.step`` (and, server-side, after
every pump iteration):

  * **kv conservation** -- ``Engine.kv_committed_tokens()`` equals an
    independent walk of live requests' ``kv_request_tokens`` (guards
    incremental-counter drift if accounting is ever cached).
  * **slot table** -- every bound ``slot_req`` entry is a live request
    (no slot held by a DONE/aborted request), live positions stay
    inside the cache, and no two slots share one request.
  * **draft rows** -- every decoder's ``bound_slots()`` is a subset of
    the live slot set (a row bound to a freed slot is a draft-pool
    leak).
  * **prefix pins** -- pin counts equal the live requests pinning each
    key, every pinned key is still cached, and pinned entries never
    exceed live requests.
  * **server streams** -- every live engine request has a registered
    stream; aborted/finished streams are deregistered.
  * **trace completeness** (when a ``repro_torch.obs`` tracer is on) --
    open ``request`` spans owned by the replica == its live requests
    at every step/pump boundary: no orphan spans, no untraced
    requests (rids mid-migration are exempt on the source until its
    ``complete_export``).

This module is import-light (stdlib only) so ``repro_torch.core`` can
import it lazily without layering cycles.
"""
from __future__ import annotations

import os
from typing import List

_ENV = "REPRO_SANITIZE"


class SanitizerError(AssertionError):
    """A conservation invariant failed at a step boundary."""


def sanitize_enabled(default: bool = False) -> bool:
    """True when REPRO_SANITIZE is set to a truthy value ('1', 'true',
    'yes', 'on')."""
    val = os.environ.get(_ENV)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def _live_requests(engine) -> List:
    from repro_torch.core.serving.request import State
    return [r for pool in (engine.running, engine.waiting) for r in pool
            if r.state is not State.DONE]


def check_engine_conservation(engine) -> List[str]:
    """Return a list of violated-invariant descriptions (empty = clean)."""
    from repro_torch.core.serving.request import State

    problems: List[str] = []
    live = _live_requests(engine)
    live_ids = {id(r) for r in live}

    # kv conservation: the committed counter vs an independent walk
    committed = engine.kv_committed_tokens()
    walked = sum(engine.kv_request_tokens(r) for r in live)
    if committed != walked:
        problems.append(
            f"kv_committed_tokens()={committed} != sum of live "
            f"kv_request_tokens={walked}")

    # slot table: bound slots <-> live requests, one slot per request
    seen_req_slots = {}
    for slot, r in enumerate(engine.slot_req):
        if r is None:
            continue
        if r.state is State.DONE or id(r) not in live_ids:
            problems.append(
                f"slot {slot} still bound to retired/aborted request "
                f"rid={r.rid} (state={r.state}) -- slot leak")
        prev = seen_req_slots.setdefault(id(r), slot)
        if prev != slot:
            problems.append(
                f"request rid={r.rid} bound to slots {prev} and {slot}")
        pos = int(engine.slot_pos[slot])
        if pos >= engine.ec.cache_len:
            problems.append(
                f"slot {slot} position {pos} outside cache_len="
                f"{engine.ec.cache_len}")

    # draft-pool rows: bound rows must be a subset of live bound slots
    bound_live = {s for s, r in enumerate(engine.slot_req) if r is not None}
    for name, dec in getattr(engine, "_decoders", {}).items():
        bound = getattr(dec, "bound_slots", None)
        if bound is None:
            continue
        leaked = set(bound()) - bound_live
        if leaked:
            problems.append(
                f"decoder `{name}` draft-pool rows {sorted(leaked)} bound "
                "to freed slots -- draft-row leak")

    # migration exports: every ticket pins a live MIGRATING request, and
    # every pinned MIGRATING request has its ticket (the export pin is the
    # acquire side of the migration protocol; complete/cancel_export are
    # the only releases)
    exports = dict(getattr(engine, "_exports", {}))
    for rid, ticket in exports.items():
        r = ticket.get("req")
        if r is None or id(r) not in live_ids:
            problems.append(
                f"export ticket rid={rid} references a request no longer "
                "live on this engine -- export pin leak")
            continue
        if r.state is not State.MIGRATING:
            problems.append(
                f"export ticket rid={rid} pinned but request state is "
                f"{r.state} (expected MIGRATING)")
        if engine.slot_req[ticket["slot"]] is not r:
            problems.append(
                f"export ticket rid={rid} slot {ticket['slot']} no longer "
                "bound to the exporting request")
    for r in live:
        if (r.state is State.MIGRATING
                and getattr(r, "_export_pin", None) is not None
                and r.rid not in exports):
            problems.append(
                f"request rid={r.rid} MIGRATING with an export pin the "
                "engine no longer tracks")

    # prefix pins: counts == live pinning requests (export tickets count
    # as holders: export_kv moves pin ownership to the ticket until the
    # source release); pinned keys cached
    pins = dict(getattr(engine, "_prefix_pins", {}))
    holders = {}
    for r in live:
        key = getattr(r, "_prefix_pin", None)
        if key is not None:
            holders[key] = holders.get(key, 0) + 1
    for ticket in exports.values():
        key = ticket.get("prefix_pin")
        if key is not None:
            holders[key] = holders.get(key, 0) + 1
    for key, n in pins.items():
        if n <= 0:
            problems.append(f"prefix pin {key[0]!r} has non-positive "
                            f"count {n}")
        held = holders.get(key, 0)
        if n != held:
            problems.append(
                f"prefix pin count {n} for variant {key[0]!r} != "
                f"{held} live request(s) holding it -- pin leak")
        if key not in engine._prefix:
            problems.append(
                f"prefix pin for variant {key[0]!r} references an entry "
                "no longer in the cache")
    for key, held in holders.items():
        if key not in pins:
            problems.append(
                f"{held} live request(s) hold prefix pin {key[0]!r} "
                "that the engine no longer counts")

    # trace completeness (repro_torch.obs): when tracing is on, the open
    # "request" spans this replica owns must match its live requests --
    # a span left open past retire/abort is an orphan the Perfetto
    # export would render as a request that never ended, and a missing
    # span means an instrumentation gap. A rid mid-migration may appear
    # live here while its trace track already moved to the importing
    # replica (the source still holds its export ticket until
    # complete_export), so exported rids are exempt on the live side.
    tracer = getattr(engine, "tracer", None)
    if tracer is not None and getattr(tracer, "enabled", False):
        rep = getattr(engine, "trace_replica", 0)
        live_rids = {r.rid for r in live}
        owned = tracer.open_requests(rep)
        for rid in sorted(live_rids - owned - set(exports)):
            problems.append(
                f"live request rid={rid} has no open trace span -- "
                "instrumentation gap")
        for rid in sorted(owned - live_rids):
            problems.append(
                f"open request span rid={rid} owned by replica {rep} "
                "has no live request -- orphan span")
    return problems


def check_server_conservation(server) -> List[str]:
    """Server-level invariants over ``AsyncLVLMServer`` + its engine."""
    problems = check_engine_conservation(server.engine)
    stream_rids = set(server._streams)
    live_rids = {r.rid for r in _live_requests(server.engine)}
    orphans = live_rids - stream_rids
    if orphans:
        problems.append(
            f"engine requests {sorted(orphans)} live with no registered "
            "stream -- token fan-out would drop them")
    for rid, stream in server._streams.items():
        if stream.aborted:
            problems.append(
                f"aborted stream rid={rid} still registered in _streams")
    return problems


def assert_conserved(obj, checker, where: str) -> None:
    problems = checker(obj)
    if problems:
        raise SanitizerError(
            f"sanitizer: {len(problems)} conservation violation(s) at "
            f"{where}:\n  - " + "\n  - ".join(problems))
