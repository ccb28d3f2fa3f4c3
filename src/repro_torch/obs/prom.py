"""Prometheus text exposition of serving metrics.

Port of ``repro.obs.prom`` (the port keeps its own copy).

Pull-based snapshot: ``AsyncLVLMServer.metrics_snapshot()`` /
``Router.metrics_snapshot()`` render their current state through these
builders into the text format a Prometheus scrape (or ``launch.serve
--metrics-out``) consumes. Latency distributions are exposed as
summary-type metrics with ``quantile`` labels (the registry already
keeps raw records, so exact quantiles are cheap and bucket boundaries
need no tuning); instantaneous state (KV load, queue depth) as gauges;
lifetime totals as counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PREFIX = "repro_"


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


class PromText:
    """Accumulates metric families and renders the text exposition."""

    def __init__(self):
        self._lines: List[str] = []
        self._seen_headers: set = set()

    def _header(self, name: str, help_text: str, mtype: str) -> None:
        if name in self._seen_headers:
            return
        self._seen_headers.add(name)
        self._lines.append(f"# HELP {name} {help_text}")
        self._lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, help_text: str, mtype: str, value, *,
               labels: Optional[Dict[str, str]] = None) -> None:
        full = _PREFIX + name
        self._header(full, help_text, mtype)
        self._lines.append(
            f"{full}{_fmt_labels(labels)} {_fmt_value(value)}")

    def counter(self, name, help_text, value, *, labels=None):
        self.sample(name, help_text, "counter", value, labels=labels)

    def gauge(self, name, help_text, value, *, labels=None):
        self.sample(name, help_text, "gauge", value, labels=labels)

    def summary(self, name: str, help_text: str, vals: Sequence[float],
                *, labels: Optional[Dict[str, str]] = None,
                quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)) -> None:
        """Summary-type family: per-quantile samples + _sum/_count."""
        full = _PREFIX + name
        self._header(full, help_text, "summary")
        base = dict(labels or {})
        for q in quantiles:
            lab = dict(base, quantile=str(q))
            v = (float(np.percentile(vals, q * 100.0))
                 if len(vals) else None)
            self._lines.append(f"{full}{_fmt_labels(lab)} {_fmt_value(v)}")
        self._lines.append(
            f"{full}_sum{_fmt_labels(base)} {_fmt_value(sum(vals))}")
        self._lines.append(
            f"{full}_count{_fmt_labels(base)} {float(len(vals))}")

    def histogram(self, name: str, help_text: str,
                  buckets: Sequence[Tuple[float, int]], sum_value: float,
                  count: int, *,
                  labels: Optional[Dict[str, str]] = None) -> None:
        """Histogram-type family: cumulative ``_bucket`` samples with
        ``le`` labels (always including ``le="+Inf"``) plus _sum/_count.
        ``buckets`` is (upper_bound, count_in_bucket) pairs -- NON
        cumulative, ascending bounds (e.g. a ``Profiler`` site's trimmed
        log2 buckets)."""
        full = _PREFIX + name
        self._header(full, help_text, "histogram")
        base = dict(labels or {})
        cum = 0
        for le, n in buckets:
            cum += int(n)
            lab = dict(base, le=format(float(le), "g"))
            self._lines.append(f"{full}_bucket{_fmt_labels(lab)} {cum}")
        lab = dict(base, le="+Inf")
        self._lines.append(f"{full}_bucket{_fmt_labels(lab)} {int(count)}")
        self._lines.append(
            f"{full}_sum{_fmt_labels(base)} {_fmt_value(sum_value)}")
        self._lines.append(f"{full}_count{_fmt_labels(base)} {int(count)}")

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


def registry_families(prom: PromText, records, *,
                      labels: Optional[Dict[str, str]] = None) -> None:
    """Render one record collection (``MetricsRegistry.records`` or a
    fleet-merged list) as the standard request-latency families."""
    done = [r for r in records if not r.aborted]
    prom.counter("requests_finished_total", "Requests finished.",
                 len(done), labels=labels)
    prom.counter("requests_aborted_total", "Requests aborted.",
                 sum(r.aborted for r in records), labels=labels)
    prom.counter("tokens_generated_total",
                 "Tokens generated by finished requests.",
                 sum(r.tokens for r in done), labels=labels)
    prom.summary("ttft_seconds", "Time to first token (virtual clock).",
                 [r.ttft for r in done if r.ttft is not None],
                 labels=labels)
    prom.summary("tpot_seconds", "Time per output token (virtual clock).",
                 [r.tpot for r in done if r.tpot is not None],
                 labels=labels)
    prom.summary("queue_wait_seconds", "Admission-gate wait.",
                 [r.queue_wait for r in records], labels=labels)
    n = len(done)
    prom.gauge("slo_goodput_ratio",
               "Fraction of finished requests meeting both SLOs.",
               (sum(r.ttft_ok and r.tpot_ok for r in done) / n
                if n else None), labels=labels)


def engine_families(prom: PromText, engine, *,
                    labels: Optional[Dict[str, str]] = None) -> None:
    """Render one engine's live state as gauges/counters."""
    prom.gauge("kv_committed_tokens", "KV tokens currently committed.",
               engine.kv_committed_tokens(), labels=labels)
    prom.gauge("kv_capacity_tokens", "KV token capacity.",
               engine.kv_capacity_tokens, labels=labels)
    prom.gauge("virtual_time_seconds", "Engine virtual clock.",
               engine.clock, labels=labels)
    prom.gauge("requests_running", "Requests in the running pool.",
               len(engine.running), labels=labels)
    prom.gauge("requests_waiting", "Requests in the scheduler queue.",
               len(engine.waiting), labels=labels)
    prom.counter("migrated_in_total", "KV imports completed.",
                 engine.migrated_in, labels=labels)
    prom.counter("migrated_out_total", "KV exports completed.",
                 engine.migrated_out, labels=labels)
    for group, cost in sorted(engine.group_costs.items()):
        prom.counter("decode_cost_seconds_total",
                     "Virtual decode cost by decoder group.",
                     cost, labels=dict(labels or {}, decoder=group))
