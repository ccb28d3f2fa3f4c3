"""``Router``: one submit surface over N ``AsyncLVLMServer`` replicas.

Port of ``repro.cluster.router``. Every replica's pump and the
consumer-side ``_migrate`` run on the event loop's thread (CUDA's
current stream is per thread); with one ``LVLM`` behind the fleet every
replica shares its weights and only the KV pools are per replica, so a
migration between replicas on one card is a device-to-device copy.

The router keeps the server's contract -- ``async for tok in
router.submit(req)`` -- while dispatching each request to a replica via a
routing policy (round-robin / least-KV / prefix-affinity), so a fleet of
engines (possibly heterogeneous: different compression presets, decoder
defaults, draft models per replica) serves one open-loop request stream:

    router = lvlm.serve_cluster(replicas=2, routing="prefix_affinity")
    async with router:
        async for tok in router.submit(req):
            ...

Roles (disaggregated serving, DistServe-style):

  * ``unified``  -- prefills AND decodes (the default; a role-less fleet
                    behaves exactly as before).
  * ``prefill``  -- runs the vision encoder + chunked prefill, then hands
                    the post-compression KV to a decode replica over the
                    modeled KV link (``CostModel.transfer_time`` charged
                    on the importer's virtual clock before its first
                    decode step there).
  * ``decode``   -- takes no fresh submits; hosts migrated-in KV and
                    decodes it.

Lifecycle:

  * healthy   -- takes new work.
  * draining  -- ``router.drain(i)``: the policy never offers it new
                 requests AND its live KV migrates out to healthy
                 decode-capable siblings (streams stay token-identical;
                 with no sibling the in-flight streams simply finish
                 here). ``undrain`` reverses it while the pump is alive.
  * dead      -- the replica's pump raised. Its queued-but-UNSTARTED
                 requests (nothing generated yet) FAIL OVER to a healthy
                 sibling transparently. Requests that had already
                 streamed tokens re-raise to their consumer (the tokens
                 cannot be un-sent); the router never re-runs a request
                 that may have observable output.

When the fleet is only TRANSIENTLY without a healthy prefill-capable
replica (everything alive is draining), ``submit`` does not fail: the
stream PARKS router-side and dispatches on ``undrain``. Only a fleet
with every replica dead raises.

Failover and migration are consumer-driven: the pump surfaces a failure
(or a ``MigrateSignal``) on the stream's next ``__anext__``; the
``RouterStream`` catches it and re-dispatches / runs the migration
protocol (source ``export_kv`` -> sibling ``import_stream`` -> source
release) from the consumer task, with no await between the import commit
and the source release -- a request is never live on two engines outside
that atomic window, and never absent from both. Everything is
event-loop-confined, like the serving layer underneath.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence

from repro_torch.core.serving.request import Request, State
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.policies import make_policy
from repro_torch.cluster.prefix_tier import SharedPrefixTier
from repro_torch.serving.server import AsyncLVLMServer, MigrateSignal, TokenStream

ROLES = ("unified", "prefill", "decode")


class Replica:
    """One ``AsyncLVLMServer`` plus its fleet-facing state and counters."""

    def __init__(self, index: int, server: AsyncLVLMServer,
                 role: str = "unified"):
        if role not in ROLES:
            raise ValueError(f"unknown replica role {role!r} "
                             f"(expected one of {ROLES})")
        self.index = index
        self.server = server
        self.role = role
        self.draining = False
        self.dispatched = 0           # requests routed here (incl. retries)
        self.completed = 0            # streams finished here (not aborted)
        self.inflight: Dict[int, Request] = {}   # rid -> assigned request

    # ------------------------------------------------------------ health --
    @property
    def dead(self) -> bool:
        return self.server._pump_error is not None

    @property
    def state(self) -> str:
        if self.dead:
            return "dead"
        return "draining" if self.draining else "ok"

    @property
    def error(self) -> Optional[BaseException]:
        return self.server._pump_error

    # -------------------------------------------------------------- role --
    @property
    def can_prefill(self) -> bool:
        return self.role in ("unified", "prefill")

    @property
    def can_decode(self) -> bool:
        return self.role in ("unified", "decode")

    @property
    def migrated_in(self) -> int:
        return self.server.engine.migrated_in

    @property
    def migrated_out(self) -> int:
        return self.server.engine.migrated_out

    # ------------------------------------------------- policy observables --
    def kv_load(self) -> float:
        """KV-reservation fraction of every live request ASSIGNED here --
        admitted or not (a dispatched request will commit its reservation
        the moment its consumer starts, so a join-the-shortest-queue
        policy must see it immediately, not after first ``__anext__``)."""
        eng = self.server.engine
        need = sum(eng.kv_request_tokens(r) for r in self.inflight.values()
                   if r.state is not State.DONE)
        return need / max(1, eng.kv_capacity_tokens)

    def queue_depth(self) -> int:
        return self.server.admission.queue_depth

    def prefix_block(self) -> int:
        return self.server.engine.ec.prefix_block

    def cached_prefix_len(self, tokens: Sequence[int],
                          compression: Optional[str] = None) -> int:
        """Longest block-aligned prefix of ``tokens`` this replica's
        engine caches UNDER the request's compression variant (None ->
        the replica's default strategy). Pure probe (``touch=False``): no
        LRU refresh -- only a real prefill hit should touch recency."""
        eng = self.server.engine
        if not eng.ec.prefix_cache:
            return 0
        k, _hit = eng._prefix_lookup([int(x) for x in tokens], touch=False,
                                     variant=compression)
        return k


class RouterStream:
    """One routed request's token channel: the ``TokenStream`` contract
    (async iteration, ``cancel()``, ``tokens``, ``aborted``) plus
    transparent failover while the request is still unstarted, parking
    while no healthy replica can take it, and consumer-side migration
    (prefill->decode handoff, drain) on ``MigrateSignal``."""

    def __init__(self, router: "Router", request: Request):
        self._router = router
        self.request = request
        self.replica: Optional[Replica] = None
        self._inner: Optional[TokenStream] = None
        self._done = False
        self.failovers = 0            # times THIS request was re-dispatched
        self.migrations = 0           # times its KV moved between replicas
        # parking (no healthy prefill-capable replica right now): the
        # stream waits here until undrain/recovery dispatches it
        self._park_evt: Optional[asyncio.Event] = None
        self._park_error: Optional[BaseException] = None

    @property
    def tokens(self) -> List[int]:
        return list(self.request.generated)

    @property
    def aborted(self) -> bool:
        return self._inner is not None and self._inner.aborted

    @property
    def parked(self) -> bool:
        return self._inner is None and not self._done

    def cancel(self) -> bool:
        self._router._streams.pop(self.request.rid, None)
        if self in self._router._parked:
            self._router._parked.remove(self)
        if self.replica is not None:
            self.replica.inflight.pop(self.request.rid, None)
        self._done = True
        if self._park_evt is not None:
            self._park_evt.set()
        return self._inner.cancel() if self._inner is not None else False

    def __aiter__(self) -> "RouterStream":
        return self

    async def __anext__(self) -> int:
        while True:
            if self._inner is None:
                if self._done:
                    raise StopAsyncIteration
                await self._wait_dispatch()
                continue
            try:
                return await self._inner.__anext__()
            except StopAsyncIteration:
                self._retire()
                raise
            except MigrateSignal:
                # the request parked in MIGRATING on its replica: run the
                # migration protocol from this consumer task, then keep
                # consuming (from the importing replica on success, from
                # the source on cancel)
                await self._router._migrate(self)
            except asyncio.CancelledError:
                # the consumer task was cancelled (client went away): free
                # the engine-side resources AND the router bookkeeping, or
                # the rid / Replica.inflight entry would leak forever and
                # least_kv would keep counting a request nobody runs
                if not self._done:
                    self.cancel()
                raise
            except Exception as exc:
                if not self._failover_eligible():
                    self._retire(failed=True)
                    raise
                self.failovers += 1
                self._router.failovers += 1
                try:
                    self._router._redispatch(self, exc)
                except BaseException:
                    self._retire(failed=True)   # no sibling: free the rid
                    raise
                # loop: continue consuming from the new replica's stream

    async def _wait_dispatch(self) -> None:
        """Parked: wait for ``undrain``/recovery to dispatch this stream
        (or for the router to give up on it)."""
        try:
            await self._park_evt.wait()
        except asyncio.CancelledError:
            if not self._done:
                self.cancel()
            raise
        if self._park_error is not None:
            err, self._park_error = self._park_error, None
            self._retire(failed=True)
            raise err

    def _failover_eligible(self) -> bool:
        """Retry only when the dead replica produced NOTHING observable:
        the pump died and this request never emitted a token."""
        return (self.replica is not None and self.replica.dead
                and not self.request.generated)

    def _retire(self, failed: bool = False) -> None:
        if self._done:
            return
        self._done = True
        self._router._streams.pop(self.request.rid, None)
        if self in self._router._parked:
            self._router._parked.remove(self)
        if self.replica is not None:
            self.replica.inflight.pop(self.request.rid, None)
            if not failed and self._inner is not None \
                    and not self._inner.aborted:
                self.replica.completed += 1


class Router:
    """Multi-engine front: routing policy + replica roles/lifecycle +
    fleet metrics over N ``AsyncLVLMServer`` replicas (see module
    docstring).

    Build via ``LVLM.serve_cluster``; construct directly to mix replicas
    of DIFFERENT models or hand-built servers. ``roles`` is a per-replica
    sequence over ``("unified", "prefill", "decode")``; a fleet with any
    ``prefill`` replica needs a decode-capable sibling to hand KV to.
    ``shared_prefix`` promotes the per-replica prefix caches to one
    cluster-shared radix tier (``SharedPrefixTier``): a prefix cached by
    ANY replica short-circuits prefill on every replica, at one modeled
    KV-link transfer per remote install. ``None`` (default) enables it
    exactly when the fleet is role-split -- there, the prefill replicas'
    caches are useless to the rest of the fleet without the shared tier.
    """

    def __init__(self, servers: Sequence[AsyncLVLMServer],
                 routing="round_robin",
                 roles: Optional[Sequence[str]] = None,
                 shared_prefix: Optional[bool] = None,
                 control=None):
        if not servers:
            raise ValueError("Router needs at least one replica")
        if roles is None:
            roles = ["unified"] * len(servers)
        if len(roles) != len(servers):
            raise ValueError(
                f"roles has {len(roles)} entries for {len(servers)} "
                "replicas")
        self.replicas = [Replica(i, s, role=r)
                         for i, (s, r) in enumerate(zip(servers, roles))]
        if not any(rep.can_prefill for rep in self.replicas):
            raise ValueError("fleet has no prefill-capable replica "
                             "(every role is 'decode')")
        if any(rep.role == "prefill" for rep in self.replicas) \
                and not any(rep.can_decode for rep in self.replicas):
            raise ValueError("'prefill' replicas need a decode-capable "
                             "('decode' or 'unified') sibling to hand "
                             "KV to")
        self.policy = make_policy(routing)
        # fleet-shared adaptive controller (repro_torch.control.Controller or
        # None): biases video-heavy dispatch toward aggressive-pruning
        # replicas while any replica is under pressure. None = zero
        # policy calls, like the null tracer.
        self.control = control
        self.metrics = ClusterMetrics(self)
        self._streams: Dict[int, RouterStream] = {}
        self._parked: List[RouterStream] = []       # FIFO dispatch order
        self.failovers = 0
        self.migrations: List[Dict] = []            # completed KV handoffs
        self.prefix_tier = self._install_prefix_tier(shared_prefix)
        for rep in self.replicas:
            # server-initiated aborts (disconnect timeouts fire inside the
            # replica pump, no consumer will ever retire the stream) must
            # drop the router's bookkeeping too, or the rid leaks forever
            rep.server.on_abort = self._on_server_abort
            # each engine gets its own track in the (fleet-shared) trace:
            # spans carried across a migration land on distinct replica
            # pids in the Perfetto export
            rep.server.engine.trace_replica = rep.index

    def _install_prefix_tier(self,
                             shared_prefix: Optional[bool]
                             ) -> Optional[SharedPrefixTier]:
        if shared_prefix is None:
            shared_prefix = any(rep.role != "unified"
                                for rep in self.replicas)
        caching = [rep for rep in self.replicas
                   if rep.server.engine.ec.prefix_cache]
        if not shared_prefix or len(caching) < 2:
            return None
        blocks = {rep.server.engine.ec.prefix_block for rep in caching}
        if len(blocks) != 1:
            return None     # heterogeneous block sizes cannot share keys
        tier = SharedPrefixTier(
            block=blocks.pop(),
            cap=sum(rep.server.engine.ec.prefix_cap for rep in caching))
        for rep in caching:
            rep.server.engine.prefix_share = tier
        return tier

    # -------------------------------------------------------- lifecycle --
    async def start(self) -> "Router":
        for rep in self.replicas:
            await rep.server.start()
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop every replica. A replica whose pump already died does not
        re-raise here: its failure either failed over or surfaced on the
        affected streams, and is kept on ``Replica.error`` for reports."""
        for stream in list(self._parked):   # parked streams never started
            stream._park_error = RuntimeError(
                "router stopped before dispatch")
            stream._park_evt.set()
        for rep in self.replicas:
            try:
                await rep.server.stop(drain=drain)
            except BaseException:
                if not rep.dead:      # pragma: no cover - defensive
                    raise

    async def __aenter__(self) -> "Router":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=not any(exc))

    def drain(self, index: int, migrate: bool = True) -> None:
        """Take replica ``index`` out of rotation: new requests route
        elsewhere, and (``migrate=True``) its live KV moves to healthy
        decode-capable siblings -- each in-flight stream continues
        token-identically from the importer. With no eligible sibling
        (or ``migrate=False``) the in-flight streams finish here, as
        before."""
        rep = self.replicas[index]
        rep.draining = True
        if not migrate:
            return
        if not any(r.can_decode and r.state == "ok" and r is not rep
                   for r in self.replicas):
            return
        for rid in list(rep.inflight):
            # DECODE-phase requests park in MIGRATING now; waiting /
            # prefilling ones get handoff=True and park after their
            # prefill -- either way the consumer drives the move
            rep.server.request_migration(rid)

    def undrain(self, index: int) -> None:
        self.replicas[index].draining = False
        self._dispatch_parked()

    # ----------------------------------------------------------- intake --
    def _candidates(self, kind: str = "prefill") -> List[Replica]:
        """Healthy replicas able to take ``kind`` work (may be empty)."""
        want = "can_prefill" if kind == "prefill" else "can_decode"
        return [rep for rep in self.replicas
                if rep.state == "ok" and getattr(rep, want)]

    def submit(self, request: Request) -> RouterStream:
        """Route ``request`` to a prefill-capable replica and return its
        stream. Like the single-server ``submit``: never blocks (replica
        admission gates on the stream's first ``__anext__``); rids are
        fleet-unique. With every healthy replica draining the stream
        PARKS until ``undrain``; only an all-dead fleet raises."""
        if request.rid in self._streams:
            raise ValueError(f"request id {request.rid} already streaming")
        stream = RouterStream(self, request)
        if self._candidates("prefill"):
            self._dispatch(stream)
        else:
            if all(rep.dead for rep in self.replicas):
                raise RuntimeError("no live replica (every pump is dead)")
            self._park(stream)
        self._streams[request.rid] = stream
        return stream

    def _park(self, stream: RouterStream) -> None:
        stream._park_evt = asyncio.Event()
        self._parked.append(stream)

    def _dispatch_parked(self) -> None:
        """Dispatch parked streams (FIFO) while a healthy prefill-capable
        replica exists; called on ``undrain``."""
        while self._parked and self._candidates("prefill"):
            stream = self._parked.pop(0)
            if stream._done:
                continue
            self._dispatch(stream)
            stream._park_evt.set()

    def _dispatch(self, stream: RouterStream) -> None:
        candidates = self._candidates("prefill")
        if self.control is not None:
            # under pressure, video-heavy requests prefer replicas whose
            # default compression is aggressive (no-op at level 0; falls
            # back to the full list when no candidate qualifies)
            candidates = self.control.route_bias(stream.request,
                                                 candidates)
        rep = self.policy.pick(stream.request, candidates)
        rep.dispatched += 1
        rep.inflight[stream.request.rid] = stream.request
        stream.replica = rep
        # a prefill-ROLE replica never decodes what it prefills: the
        # request hands its KV off right after its first token
        stream.request.handoff = (rep.role == "prefill")
        stream._inner = rep.server.submit(stream.request)

    def _redispatch(self, stream: RouterStream, cause: BaseException) -> None:
        """Failover: the request never started on the dead replica, so its
        runtime state resets to a fresh submit and a sibling takes it --
        or, with every survivor draining, the stream parks until one
        rejoins."""
        if stream.replica is not None:
            stream.replica.inflight.pop(stream.request.rid, None)
        _reset_for_retry(stream.request)
        if self._candidates("prefill"):
            self._dispatch(stream)
            return
        if all(rep.dead for rep in self.replicas):
            raise RuntimeError(
                f"request {stream.request.rid}: replica "
                f"{stream.replica.index} died and no live sibling "
                "remains") from cause
        stream.replica = None
        stream._inner = None
        self._park(stream)

    # -------------------------------------------------------- migration --
    async def _migrate(self, stream: RouterStream) -> None:
        """Move ``stream``'s request (parked in MIGRATING on its replica)
        to a healthy decode-capable sibling: export the KV, commit the
        import through the target's admission gate, then release the
        source -- with NO await between commit and release, so the
        request is live on exactly one engine at every yield point. When
        no sibling can take it, the export cancels and the request
        resumes decoding where it is."""
        req = stream.request
        src = stream.replica
        rid = req.rid
        src_eng = src.server.engine
        try:
            ticket = src_eng.export_kv(rid)
        except (KeyError, RuntimeError):
            return      # finished/aborted in the signal gap: nothing to do
        transfer_s = src_eng.ec.cost.transfer_time(int(ticket["pos"]))
        ready_at = float(ticket["clock"]) + transfer_s
        # dedicated decode replicas first, then unified, least KV first
        targets = sorted(
            (rep for rep in self._candidates("decode") if rep is not src),
            key=lambda rep: (rep.role != "decode", rep.kv_load()))
        for dst in targets:
            try:
                inner = await dst.server.import_stream(req, ticket,
                                                       ready_at=ready_at)
            except Exception:
                continue     # this task still holds the export pin: retry
            # import committed on ``dst``: release the source and swap the
            # stream over, no awaits until done (exactly-once)
            src.server.complete_export(rid)
            src.server.release_migrated(rid)
            src.inflight.pop(rid, None)
            dst.inflight[rid] = req
            stream.replica = dst
            stream._inner = inner
            stream.migrations += 1
            self.migrations.append({
                "rid": rid, "src": src.index, "dst": dst.index,
                "kv_tokens": int(ticket["pos"]),
                "prefill_s": (req.first_token_time - req.arrival
                              if req.first_token_time is not None
                              else None),
                "transfer_s": transfer_s,
                "ready_at": ready_at,
            })
            return
        src.server.cancel_export(rid)   # nobody could take it: resume here

    def abort(self, rid: int) -> bool:
        stream = self._streams.get(rid)
        return stream.cancel() if stream is not None else False

    def _on_server_abort(self, rid: int) -> None:
        """A replica aborted ``rid`` on its own (disconnect timeout,
        direct ``server.abort``): retire the router stream so the rid
        frees up. A consumer that comes back can still drain the tokens
        already fanned out (the inner channel keeps them)."""
        stream = self._streams.get(rid)
        if stream is not None and stream._inner is not None \
                and stream._inner.aborted:
            stream._retire()

    # ---------------------------------------------------------- reports --
    def summary(self) -> Dict:
        """Fleet-wide merged metrics (see ``ClusterMetrics.summary``)."""
        return self.metrics.summary()

    def metrics_snapshot(self) -> str:
        """Fleet metrics in Prometheus text format: every replica's
        families labeled ``replica="i"`` plus router-level counters
        (failovers, migrations, shared-prefix-tier hits). The scrape
        surface ``launch.serve --metrics-out`` writes."""
        from repro_torch.obs.prom import PromText
        parts = [rep.server.metrics_snapshot(replica=rep.index)
                 for rep in self.replicas]
        prom = PromText()
        prom.counter("failovers_total",
                     "Requests re-dispatched after a replica died.",
                     self.failovers)
        prom.counter("migrations_total", "Completed KV migrations.",
                     len(self.migrations))
        prom.counter(
            "migrated_kv_tokens_total", "KV tokens moved between replicas.",
            sum(m["kv_tokens"] for m in self.migrations))
        if self.prefix_tier is not None:
            stats = self.prefix_tier.stats()
            prom.counter("prefix_tier_hits_total",
                         "Shared-prefix-tier lookup hits.", stats["hits"])
            prom.counter("prefix_tier_misses_total",
                         "Shared-prefix-tier lookup misses.",
                         stats["misses"])
            prom.gauge("prefix_tier_entries",
                       "Entries resident in the shared prefix tier.",
                       stats["entries"])
        # the fleet shares ONE profiler (like the tracer), so its site
        # histograms render once at router level, not per replica
        profiler = self.replicas[0].server.profiler if self.replicas \
            else None
        if profiler is not None and profiler.enabled:
            from repro_torch.obs.profile import profile_families
            profile_families(prom, profiler)
        # ... and ONE adaptive controller: its repro_control_* families
        # (per-replica ladder level, actuation counters) render here too
        if self.control is not None:
            self.control.prom_families(prom)
        return "".join(parts) + prom.render()


def _reset_for_retry(req: Request) -> None:
    """Return a never-started request to its pre-submit state so a sibling
    replica can run it from scratch (failover path; the caller guarantees
    ``req.generated`` is empty)."""
    from repro_torch.core.serving.request import State

    assert not req.generated, "cannot retry a request with emitted tokens"
    req.state = State.WAITING
    req.prefill_done = 0
    req.aborted = False
    req.first_token_time = None
    req.finish_time = None
    req.served_tokens = 0
    req.handoff = False
    # the sibling re-resolves the compression strategy (its registry /
    # default may differ), so the stamped post-compression count resets
    req.nv_compressed = None
    for attr in ("_slot", "_ve", "_prefix_pin", "_needs_ttft",
                 "_gate_clock", "_comp_name", "_imported", "_ready_at",
                 "_export_pin"):
        if hasattr(req, attr):
            delattr(req, attr)
