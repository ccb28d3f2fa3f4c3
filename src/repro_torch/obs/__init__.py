"""``repro_torch.obs`` -- zero-overhead-when-off observability.

Port of ``repro.obs`` (its own copy: the port imports no module of
``repro``). Per-request lifecycle tracing (``Tracer`` -- dual
virtual/wall clocks), Chrome-trace/Perfetto export (``perfetto``),
Prometheus text metric snapshots (``prom``), continuous hot-path
profiling (``profile``), shared summary statistics (``stats``), and
trace validation (``python -m repro_torch.obs.validate``).

Enable via the facade: ``lvlm.serve(..., obs=True, profile=True)`` or
``lvlm.serve_async(..., obs=True)``, or pass a ``Tracer`` / ``Profiler``;
disabled (the default) the stack holds ``NULL_TRACER`` / ``NULL_PROFILER``
and every instrumentation site short-circuits on ``.enabled``.
``regress`` is the JSON perf-regression gate
(``python -m repro_torch.obs.regress CURRENT BASELINE``).
"""
from repro_torch.obs.perfetto import to_chrome_trace, write_chrome_trace
from repro_torch.obs.profile import (NULL_PROFILER, NullProfiler, Profiler,
                                     profile_families)
from repro_torch.obs.regress import compare, flatten
from repro_torch.obs.stats import (mean_or_none, percentile_summary,
                                   summarize_records)
from repro_torch.obs.trace import NULL_TRACER, JsonlSink, NullTracer, Tracer
from repro_torch.obs.validate import load_trace, validate_trace

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "JsonlSink",
    "Profiler", "NullProfiler", "NULL_PROFILER", "profile_families",
    "to_chrome_trace", "write_chrome_trace",
    "summarize_records", "percentile_summary", "mean_or_none",
    "load_trace", "validate_trace", "compare", "flatten",
]
