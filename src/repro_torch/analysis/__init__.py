"""``repro_torch.analysis`` -- the port's static analyzer and its runtime
sanitizer.

Port of ``repro.analysis``. The static half lints the port's package and
``chip_smoke.py``:

  * **L-rules** (layering): ``repro_torch.core.*`` stays internal; the
    port's ``EngineConfig.compression`` is never mutated outside its api
    and core; ``Engine`` is constructed only inside the port's package
    (and its tests and ``chip_smoke.py``).
  * **R-rules** (resource pairing) and **A-rules** (async hazards): the
    reference's, over the port's engine, server, router, admission gate
    and controller, which keep the reference's names.
  * **K-rules** (kernel bindings): each wrapper's ctypes ``argtypes`` /
    ``restype`` against the ``extern "C"`` definition in ``csrc/<lib>.cu``,
    each call's arity, the shapes a wrapper admits against those its
    library instantiates, and every launch's return code raised on.
  * **O-rules** (tracing): span and profiler-site pairing. The
    reference's O002 has no subject here (no kernel body is Python).

CLI::

    PYTHONPATH=src python -m repro_torch.analysis [--rules L001,K] [paths]

It exits 0 when clean and 1 on findings; the port commits no baseline.
The reference's ``python -m repro.analysis`` goes on governing all of
``src/``, this package included.

The runtime half (``repro_torch.analysis.sanitizer``) ports the
conservation checks of ``repro.analysis.sanitizer``
(``check_engine_conservation``, ``check_server_conservation``,
``assert_conserved``, ``sanitize_enabled``, ``SanitizerError``).
"""
from repro_torch.analysis.findings import Baseline, Finding, parse_waivers
from repro_torch.analysis.registry import (ALL_RULES, RULE_FAMILIES,
                                          select_rules)
from repro_torch.analysis.runner import (DEFAULT_PATHS, analyze_file,
                                         analyze_source, run_analysis)
from repro_torch.analysis.sanitizer import (SanitizerError, assert_conserved,
                                            check_engine_conservation,
                                            check_server_conservation,
                                            sanitize_enabled)

__all__ = [
    "Finding", "Baseline", "parse_waivers",
    "ALL_RULES", "RULE_FAMILIES", "select_rules",
    "analyze_source", "analyze_file", "run_analysis", "DEFAULT_PATHS",
    "SanitizerError", "assert_conserved", "check_engine_conservation",
    "check_server_conservation", "sanitize_enabled",
]
