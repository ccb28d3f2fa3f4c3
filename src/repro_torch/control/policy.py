"""Table-driven SLO-adaptive quality policy (the degradation ladder).

Port of ``repro.control.policy`` (same ladder, same hysteresis).

The paper's acceleration knobs -- visual-token compression ratio,
speculative ``gamma``, early-exit confidence thresholds -- all trade
quality for latency, and the right operating point depends on load
(EffiVLM-BENCH measures exactly this frontier offline; the sweep harness
in ``repro_torch.control.sweep`` reproduces that measurement). This module is
the ONLINE half's brain: a small, fully-deterministic state machine that
maps a scalar *pressure* signal onto a rung of a degradation ladder.

The ladder is a table (``ControlConfig.ladder``): rung 0 is the
preferred operating point (no overrides at all); each deeper rung names
a more aggressive compression preset, a decoder remap (the per-request
way to shrink speculative lookahead all the way to zero:
``speculative -> greedy``), a ``gamma_scale`` applied to the engine's
registered speculative decoders, and an ``exit_scale`` applied to the
early-exit confidence threshold (scaling the threshold DOWN makes exits
fire earlier -- the degrade direction: fewer layers per token).

Thrash-proofing is structural, not statistical:

  * hysteresis -- the level only RISES when pressure >= ``high_pressure``
    and only FALLS when pressure <= ``low_pressure`` (a strict band, so a
    pressure sitting between the marks changes nothing);
  * cooldown -- consecutive level changes are separated by at least
    ``cooldown_s`` on the engine's virtual clock, and each change moves
    exactly ONE rung.

Together these give the no-oscillation property the hypothesis suite
locks down: for ANY pressure trace, two level changes are never closer
than ``cooldown_s``, so presets cannot flap within a cooldown window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ControlLevel:
    """One rung of the degradation ladder.

    ``compression=None`` / empty ``decoder_map`` / scale 1.0 mean "leave
    that knob alone" -- rung 0 is all-defaults, i.e. no actuation.
    """
    name: str
    compression: Optional[str] = None      # Request.compression override
    decoder_map: Tuple[Tuple[str, str], ...] = ()   # e.g. (("speculative",
    #                                                        "greedy"),)
    gamma_scale: float = 1.0               # engine speculative gamma scale
    exit_scale: float = 1.0                # early-exit threshold scale (<1
    #                                        = exit earlier = cheaper)

    def remap_decoder(self, name: str) -> Optional[str]:
        for src, dst in self.decoder_map:
            if src == name:
                return dst
        return None


#: Preferred -> degraded -> aggressive. Ratios follow the presets the
#: sweep harness measures, so an operator can read the offline frontier
#: (the sweep's pareto document) and know what each rung costs in quality.
DEFAULT_LADDER: Tuple[ControlLevel, ...] = (
    ControlLevel("preferred"),
    ControlLevel("degraded", compression="fastv-0.5", gamma_scale=0.5),
    ControlLevel("aggressive", compression="fastv-0.25",
                 decoder_map=(("speculative", "greedy"),),
                 gamma_scale=0.25, exit_scale=0.8),
)


@dataclasses.dataclass
class ControlConfig:
    """Knobs of the adaptive policy (all deterministic; virtual-clock
    cooldown, so traced/paced runs behave identically)."""
    ladder: Tuple[ControlLevel, ...] = DEFAULT_LADDER
    high_pressure: float = 0.85      # raise the level at/above this
    low_pressure: float = 0.60       # lower the level at/below this
    cooldown_s: float = 0.005        # min virtual s between level changes
    queue_ref: int = 4               # deferred-queue depth that alone
    #                                  saturates the pressure signal
    route_keep_max: float = 0.5      # replicas whose default compression
    #                                  keeps <= this fraction of visual
    #                                  tokens count as "aggressive" for
    #                                  the video routing bias

    def __post_init__(self):
        if len(self.ladder) < 1:
            raise ValueError("ladder needs at least the preferred rung")
        if self.ladder[0].compression is not None \
                or self.ladder[0].decoder_map \
                or self.ladder[0].gamma_scale != 1.0 \
                or self.ladder[0].exit_scale != 1.0:
            raise ValueError("ladder rung 0 must be the no-override "
                             "preferred operating point")
        if not 0.0 < self.low_pressure < self.high_pressure <= 2.0:
            raise ValueError("need 0 < low_pressure < high_pressure")
        if self.cooldown_s < 0.0:
            raise ValueError("cooldown_s must be >= 0")
        if self.queue_ref < 1:
            raise ValueError("queue_ref must be >= 1")


@dataclasses.dataclass
class LevelState:
    """Per-server hysteresis state: current rung + last-change clock."""
    level: int = 0
    last_change: float = float("-inf")


class AdaptivePolicy:
    """The pressure -> ladder-rung map (see module docstring).

    Stateless over servers: callers hold one ``LevelState`` per server
    and pass it to ``update``. This keeps the no-thrash property a
    one-object unit the property tests can drive with adversarial
    pressure traces and synthetic clocks.
    """

    def __init__(self, cfg: Optional[ControlConfig] = None):
        self.cfg = cfg if cfg is not None else ControlConfig()

    # ---------------------------------------------------------- signals --
    def pressure(self, server) -> float:
        """Scalar load signal in [0, ~1]: the max of the KV-watermark
        fraction and the (normalized) admission deferred-queue depth --
        exactly the two time-series ``_emit_counters`` /
        ``metrics_snapshot()`` already export (``kv_committed_tokens``,
        ``admission_queue_depth``), read live instead of scraped."""
        eng = server.engine
        kv = eng.kv_committed_tokens() / max(1, eng.kv_capacity_tokens)
        q = server.admission.queue_depth / float(self.cfg.queue_ref)
        return max(kv, min(1.0, q))

    # ------------------------------------------------------------ update --
    def update(self, state: LevelState, pressure: float,
               clock: float) -> int:
        """Advance ``state`` by at most ONE rung for this observation.

        Hysteresis band + cooldown (see module docstring). Returns the
        (possibly unchanged) level. Pure in everything but ``state``."""
        cfg = self.cfg
        if clock - state.last_change < cfg.cooldown_s:
            return state.level
        if pressure >= cfg.high_pressure \
                and state.level < len(cfg.ladder) - 1:
            state.level += 1
            state.last_change = clock
        elif pressure <= cfg.low_pressure and state.level > 0:
            state.level -= 1
            state.last_change = clock
        return state.level

    def rung(self, level: int) -> ControlLevel:
        return self.cfg.ladder[level]

    # ------------------------------------------------------- actuations --
    def overrides_for(self, level: int, compression: Optional[str],
                      decoder: Optional[str], default_decoder: str
                      ) -> Dict[str, Optional[str]]:
        """Per-request field rewrites for ``level`` given the request's
        CURRENT preferred fields (``None`` = engine default). Empty dict
        = nothing to change at this rung."""
        rung = self.rung(level)
        out: Dict[str, Optional[str]] = {}
        if rung.compression is not None \
                and rung.compression != compression:
            out["compression"] = rung.compression
        eff = decoder if decoder is not None else default_decoder
        mapped = rung.remap_decoder(eff)
        if mapped is not None and mapped != decoder:
            out["decoder"] = mapped
        return out
