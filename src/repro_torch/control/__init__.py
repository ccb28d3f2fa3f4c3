"""``repro_torch.control``: SLO-adaptive quality control + Pareto sweeps.

Port of ``repro.control``.

Two halves of one loop (ROADMAP's "EffiVLM-BENCH-style Pareto sweep
harness + SLO-adaptive quality control" item):

  * OFFLINE -- ``repro_torch.control.sweep`` measures the
    quality-vs-latency frontier over (compression x decoder x replica
    mix x arrival rate) into a schema-v1 pareto document;
  * ONLINE -- ``AdaptivePolicy`` (the table-driven degradation ladder,
    ``repro_torch.control.policy``) + ``Controller`` (the actuator
    threaded through server admission and router dispatch,
    ``repro_torch.control.controller``) walk that frontier live: under
    KV/SLO pressure requests degrade to aggressive presets instead of
    deferring, and recover when pressure drops.

Enable with ``control=True`` (defaults), a ``ControlConfig``, an
``AdaptivePolicy``, or a prebuilt ``Controller`` on ``LVLM.serve`` /
``serve_async`` / ``serve_cluster``. ``control=None`` (the default)
makes ZERO policy calls.
"""
from repro_torch.control.controller import Controller
from repro_torch.control.policy import (AdaptivePolicy, ControlConfig,
                                  ControlLevel, DEFAULT_LADDER,
                                  LevelState)
from repro_torch.control.sweep import (FRONTIER_AXES, SweepConfig, dominates,
                                 pareto_frontier, point_key, run_sweep,
                                 write_pareto)

__all__ = [
    "AdaptivePolicy", "ControlConfig", "ControlLevel", "Controller",
    "DEFAULT_LADDER", "LevelState",
    "FRONTIER_AXES", "SweepConfig", "dominates", "pareto_frontier",
    "point_key", "run_sweep", "write_pareto",
]
