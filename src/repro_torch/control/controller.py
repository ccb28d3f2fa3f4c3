"""``Controller``: the online SLO-adaptive actuator.

Port of ``repro.control.controller``.

One controller instance fronts a server -- or a whole fleet (the
``serve_cluster(control=...)`` path shares ONE controller across every
replica plus the Router, like the tracer/profiler) -- and closes the
loop the ROADMAP asked for: under KV/SLO pressure the serving layer
*degrades gracefully instead of deferring*; when pressure drops it
*recovers fully* to the preferred operating point.

Wiring (every call site is guarded by ``if control is not None:`` so
``control=None`` makes ZERO policy calls -- the zero-overhead-when-off
discipline the tracer/profiler established, locked by the same
patch-to-raise test):

  * ``AsyncLVLMServer._admit`` calls ``shape(server, req)`` before the
    admission gate: at rung > 0 the incoming request's ``compression`` /
    ``decoder`` fields are rewritten to the rung's aggressive preset
    (shrinking its KV need BEFORE the watermark check);
  * the server pump calls ``on_step(server)`` once per iteration: the
    policy re-reads the live pressure signals, walks the hysteresis +
    cooldown state machine, applies the rung's engine-level knobs
    (speculative ``gamma`` scale, early-exit threshold scale), reshapes
    every DEFERRED waiter to the new rung -- deepening or REVERTING its
    override -- refreshes the queued KV needs, and re-enters
    ``maybe_admit`` so shrunken requests drain immediately;
  * ``_admit`` resolution calls ``commit(req)`` (the request enters the
    engine under its current fields -- the override is consumed) or
    ``revert(req)`` (cancelled/retracted at the gate: the request gets
    its preferred fields back, so nothing stays degraded by accident);
  * the Router calls ``route_bias(req, candidates)`` at dispatch: while
    any replica is under pressure, video-heavy requests prefer replicas
    whose DEFAULT compression is aggressive (``policies.
    prefer_aggressive``).

Override lifecycle is a tracked resource (analysis R-table
``control_override``): the ``_overrides[rid]`` bind is the acquire;
every CFG path must consume it via ``commit`` or restore it via
``revert`` -- no request is ever left permanently downgraded after
pressure clears. Every actuation is traced (``control_actuation`` /
``control_level`` instants) and counted; ``metrics_snapshot()`` exposes
the ``repro_control_*`` families.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.control.policy import (AdaptivePolicy, ControlConfig,
                                  LevelState)

_ACTUATION_KINDS = ("compression", "decoder", "gamma", "exit", "route")


class Controller:
    """Fleet-shareable adaptive-control actuator (see module docstring)."""

    def __init__(self, policy=None):
        if policy is None:
            policy = AdaptivePolicy()
        elif isinstance(policy, ControlConfig):
            policy = AdaptivePolicy(policy)
        elif not isinstance(policy, AdaptivePolicy):
            raise TypeError("control= expects None/True, a ControlConfig, "
                            f"an AdaptivePolicy, or a Controller; got "
                            f"{policy!r}")
        self.policy = policy
        # per-server hysteresis state + per-engine preferred knob values
        self._state: Dict[int, LevelState] = {}
        self._servers: List = []
        self._knob_orig: Dict[int, Dict[str, Dict[str, float]]] = {}
        # rid -> (preferred compression, preferred decoder): the override
        # record -- acquire here, release in commit()/revert() (R-table
        # resource ``control_override``)
        self._overrides: Dict[int, Tuple[Optional[str], Optional[str]]] = {}
        self.actuations: Dict[str, int] = {k: 0 for k in _ACTUATION_KINDS}
        self.commits = 0
        self.reverts = 0
        self.level_changes = 0

    # --------------------------------------------------------- lifecycle --
    def attach(self, server) -> None:
        """Register a server (one per replica; idempotent). Captures the
        engine's PREFERRED decoder knobs so rung scales always apply to
        the originals and rung 0 restores them exactly."""
        sid = id(server)
        if sid in self._state:
            return
        self._state[sid] = LevelState()
        self._servers.append(server)
        eng = server.engine
        orig: Dict[str, Dict[str, float]] = {}
        for name, dec in eng._decoders.items():
            knobs: Dict[str, float] = {}
            if hasattr(dec, "gamma"):
                knobs["gamma"] = float(dec.gamma)
            if hasattr(dec, "threshold"):
                knobs["threshold"] = float(dec.threshold)
            if knobs:
                orig[name] = knobs
        self._knob_orig[id(eng)] = orig

    def level(self, server) -> int:
        st = self._state.get(id(server))
        return st.level if st is not None else 0

    @property
    def fleet_level(self) -> int:
        """Deepest rung any attached server currently sits on."""
        return max((st.level for st in self._state.values()), default=0)

    # -------------------------------------------------------- pump hook --
    def on_step(self, server) -> int:
        """Per-pump-iteration hook: observe pressure, walk the hysteresis
        state machine, and on a level change actuate engine knobs +
        reshape the deferred queue. Returns the current level."""
        st = self._state.get(id(server))
        if st is None:
            self.attach(server)
            st = self._state[id(server)]
        prof = server.profiler
        if prof.enabled:
            prof.site_begin("control_step")
        before = st.level
        level = self.policy.update(st, self.policy.pressure(server),
                                   server.engine.clock)
        if level != before:
            self.level_changes += 1
            if server.tracer.enabled:
                server.tracer.instant(
                    "control_level", replica=server.engine.trace_replica,
                    vt=server.engine.clock, level=level,
                    rung=self.policy.rung(level).name)
            self._apply_engine_knobs(server, level)
            self._reshape_deferred(server, level)
        if prof.enabled:
            prof.site_end("control_step")
        return level

    def _apply_engine_knobs(self, server, level: int) -> None:
        """Scale the registered decoders' gamma / early-exit threshold
        for this rung, relative to the PREFERRED values captured at
        attach (so rung 0 is an exact restore). Shrinking gamma below a
        running request's reservation is safe -- ``Request.lookahead``
        was stamped at submit and the verify clamp bounds block writes --
        it simply drafts shorter blocks from the next round on."""
        rung = self.policy.rung(level)
        eng = server.engine
        for name, knobs in self._knob_orig.get(id(eng), {}).items():
            dec = eng._decoders.get(name)
            if dec is None:
                continue
            if "gamma" in knobs:
                g = max(1, int(round(knobs["gamma"] * rung.gamma_scale)))
                if g != dec.gamma:
                    dec.gamma = g
                    self.actuations["gamma"] += 1
                    if server.tracer.enabled:
                        server.tracer.instant(
                            "control_actuation",
                            replica=eng.trace_replica, vt=eng.clock,
                            kind="gamma", decoder=name, value=g)
            if "threshold" in knobs:
                t = knobs["threshold"] * rung.exit_scale
                if t != dec.threshold:
                    dec.threshold = t
                    self.actuations["exit"] += 1
                    if server.tracer.enabled:
                        server.tracer.instant(
                            "control_actuation",
                            replica=eng.trace_replica, vt=eng.clock,
                            kind="exit", decoder=name, value=t)

    def _reshape_deferred(self, server, level: int) -> None:
        """Rewrite every DEFERRED waiter to the new rung -- deeper
        presets under pressure, full revert at rung 0 -- refresh the
        queued KV needs (stale needs would gate admission on tokens the
        pruner will drop), then re-enter ``maybe_admit`` so anything
        that now fits drains immediately (the hysteresis re-entry the
        property suite proves deadlock-free)."""
        adm = server.admission
        touched = False
        for entry in list(adm._waiters):
            req = entry[1]
            if getattr(req, "_imported", False):
                continue     # migrated-in KV is already post-compression
            if level > 0:
                changed = self._apply(server, req, level)
            else:
                changed = self.revert(req)
            if changed:
                adm.refresh(req)
                touched = True
        if touched:
            adm.maybe_admit()

    # -------------------------------------------------- request shaping --
    def shape(self, server, req) -> bool:
        """Admission-time hook: rewrite an INCOMING request to the
        server's current rung (no-op at rung 0). Returns True if any
        field changed."""
        st = self._state.get(id(server))
        if st is None:
            self.attach(server)
            st = self._state[id(server)]
        if st.level == 0:
            return False
        return self._apply(server, req, st.level)

    def shape_sync(self, engine, req) -> bool:
        """Closed-loop (``LVLM.serve``) variant: pressure is the KV
        fraction of what is already submitted; an override applied here
        is committed immediately (the request is being submitted now)."""
        sid = id(engine)
        st = self._state.setdefault(sid, LevelState())
        kv = engine.kv_committed_tokens() / max(1,
                                                engine.kv_capacity_tokens)
        before = st.level
        level = self.policy.update(st, kv, engine.clock)
        if level != before:
            self.level_changes += 1
        if level == 0:
            return False
        changed = self._apply_fields(req, level, engine._default_name,
                                     tracer=engine.tracer,
                                     replica=engine.trace_replica,
                                     vt=engine.clock)
        if changed:
            self.commit(req)
        return changed

    def _apply(self, server, req, level: int) -> bool:
        return self._apply_fields(req, level, server.engine._default_name,
                                  tracer=server.tracer,
                                  replica=server.engine.trace_replica,
                                  vt=server.engine.clock)

    def _apply_fields(self, req, level: int, default_decoder: str, *,
                      tracer, replica: int, vt: float) -> bool:
        rid = req.rid
        prior = self._overrides.get(rid)
        base_comp, base_dec = prior if prior is not None \
            else (req.compression, req.decoder)
        ov = self.policy.overrides_for(level, base_comp, base_dec,
                                       default_decoder)
        if not ov:
            # this rung leaves the request's preferred fields alone; a
            # shallower rung after a deeper one must restore them
            if prior is not None:
                return self.revert(req)
            return False
        if prior is None:
            self._overrides[rid] = (base_comp, base_dec)   # acquire
        new_comp = ov.get("compression", base_comp)
        new_dec = ov.get("decoder", base_dec)
        if new_comp == req.compression and new_dec == req.decoder:
            return False
        req.compression = new_comp
        req.decoder = new_dec
        # the stamped post-compression count belongs to the OLD strategy
        req.nv_compressed = None
        for kind in ov:
            self.actuations[kind] += 1
            if tracer.enabled:
                tracer.instant("control_actuation", rid, replica=replica,
                               vt=vt, kind=kind, to=ov[kind],
                               level=level)
        return True

    # ------------------------------------------------ override lifecycle --
    def commit(self, req) -> bool:
        """The request entered the engine under its current (possibly
        degraded) fields: consume the override record."""
        rec = self._overrides.pop(req.rid, None)
        if rec is None:
            return False
        self.commits += 1
        return True

    def revert(self, req) -> bool:
        """Restore the request's PREFERRED fields (pressure cleared while
        it was still deferred, or it was cancelled at the gate)."""
        rec = self._overrides.pop(req.rid, None)
        if rec is None:
            return False
        orig_comp, orig_dec = rec
        req.compression = orig_comp
        req.decoder = orig_dec
        req.nv_compressed = None
        self.reverts += 1
        return True

    # ----------------------------------------------------------- routing --
    def route_bias(self, request, candidates: List) -> List:
        """Dispatch-time bias: while ANY replica is under pressure,
        video-heavy requests prefer aggressive-pruning replicas (their
        default strategy keeps <= ``route_keep_max`` of visual tokens).
        Falls back to the full candidate list when none qualify."""
        if getattr(request, "visual_embeds", None) is None \
                or self.fleet_level == 0 or len(candidates) < 2:
            return candidates
        from repro_torch.cluster.policies import prefer_aggressive
        aggressive = prefer_aggressive(
            candidates, max_keep=self.policy.cfg.route_keep_max)
        if aggressive and len(aggressive) < len(candidates):
            self.actuations["route"] += 1
            return aggressive
        return candidates

    # ----------------------------------------------------------- reports --
    def summary(self) -> Dict:
        out = {"control_level": self.fleet_level,
               "control_commits": self.commits,
               "control_reverts": self.reverts,
               "control_level_changes": self.level_changes,
               "control_overrides_open": len(self._overrides)}
        for kind, n in self.actuations.items():
            out[f"control_actuations/{kind}"] = n
        return out

    def prom_families(self, prom) -> None:
        """Render the ``repro_control_*`` families into a ``PromText``
        (the server renders them standalone; a fleet renders them ONCE
        at router level, like the shared profiler)."""
        for server in self._servers:
            prom.gauge("control_level",
                       "Current degradation-ladder rung (0 = preferred).",
                       self.level(server),
                       labels={"replica":
                               str(server.engine.trace_replica)})
        for kind in _ACTUATION_KINDS:
            prom.counter("control_actuations_total",
                         "Controller actuations by kind.",
                         self.actuations[kind], labels={"kind": kind})
        prom.counter("control_commits_total",
                     "Overrides committed into the engine.", self.commits)
        prom.counter("control_reverts_total",
                     "Overrides reverted to preferred fields.",
                     self.reverts)
        prom.counter("control_level_changes_total",
                     "Hysteresis level transitions.", self.level_changes)
        prom.gauge("control_overrides_open",
                   "Deferred requests currently holding an override.",
                   len(self._overrides))
