"""The traced run's device trace: ``torch.profiler`` (device activity
only, so the host runs as it would) over a bounded stretch of engine
steps inside the window, reduced to what the readers need.

- device operations: every CUDA-side event (kernels, copies, sets) but
  the profiler's annotations, by base name (``void (anonymous
  namespace)::flash_fwd_kernel<128>(...)`` -> ``flash_fwd_kernel``);
- busy: the union of their intervals; ``window_s``: the traced stretch;
- host spans: the benchmark's own (``harness.probe``: every engine step,
  and the model calls inside it), on the host's clock and moved onto the
  trace's (epoch nanoseconds) by the offset read when tracing began;
- idle gaps: the stretches with no device operation, cut where a host
  span begins or ends, each piece named by the innermost host span
  around it (``between engine steps`` outside them).

A trace with no device event gives no device numbers, and the readers
then return nothing.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

_TEMPLATE = re.compile(r"[<(]")


def base_name(name: str) -> str:
    """The kernel's own name: no return type, namespaces, template
    arguments or parameters."""
    n = name.strip()
    if n.startswith("void "):
        n = n[5:]
    n = n.replace("(anonymous namespace)::", "")
    m = _TEMPLATE.search(n)
    if m:
        n = n[:m.start()]
    return n.rsplit("::", 1)[-1].strip()[:96] or name[:96]


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(base name, start ns, end ns) of every device-side event."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    return [(base_name(n), s, e) for n, s, e in out
            if not n.startswith(("bench.", "ProfilerStep"))]


def union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _overlap(a: List[Tuple[int, int]], lo: int, hi: int) -> int:
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in a)


class DeviceTrace:
    """One traced stretch, reduced (see the module docstring).
    ``spans``: (label, start ns, end ns) of the host's work, on the
    trace's clock; ``t0`` / ``t1``: the stretch."""

    def __init__(self, ops, spans, t0: int, t1: int):
        self.ops = ops
        self.window_s = (t1 - t0) * 1e-9
        self.t0, self.t1 = t0, t1
        self.busy_iv = union([(s, e) for _, s, e in ops])
        self.busy_s = _overlap(self.busy_iv, t0, t1) * 1e-9
        self.steps = [(s, e) for n, s, e in spans if n == "engine_step"]
        self.calls = [(s, e, n) for n, s, e in spans if n != "engine_step"]

    @property
    def has_device(self) -> bool:
        return bool(self.ops)

    def kernel_s(self, prefix: str) -> float:
        """Device seconds of the operations whose base name starts with
        ``prefix``."""
        return sum(e - s for n, s, e in self.ops
                   if n.startswith(prefix)) * 1e-9

    def idle_share_in_steps(self):
        """Share of the time inside engine steps with no device work."""
        total = sum(e - s for s, e in self.steps)
        if not total or not self.ops:
            return None
        busy = sum(_overlap(self.busy_iv, s, e) for s, e in self.steps)
        return 1.0 - busy / total

    def top_ops(self, n: int = 10) -> List[List]:
        acc: Dict[str, int] = {}
        for name, s, e in self.ops:
            acc[name] = acc.get(name, 0) + (e - s)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def _host_at(self, t: int) -> str:
        for s, e, n in self.calls:
            if s <= t < e:
                return f"in Model.{n}"
        for s, e in self.steps:
            if s <= t < e:
                return "in Engine.step, outside the model"
        return "between engine steps"

    def idle_gaps(self, n: int = 10, min_ns: int = 10_000) -> List[List]:
        """Idle stretches of the traced window, each cut where a host span
        begins or ends and summed by what the host was doing, longest
        first."""
        edges = sorted({t for s, e, _ in self.calls for t in (s, e)}
                       | {t for s, e in self.steps for t in (s, e)})
        acc: Dict[str, int] = {}
        prev = self.t0
        for s, e in self.busy_iv + [(self.t1, self.t1)]:
            s, e = max(s, self.t0), min(e, self.t1)
            if s - prev >= min_ns:
                cuts = [prev] + [t for t in edges if prev < t < s] + [s]
                for a, b in zip(cuts, cuts[1:]):
                    key = self._host_at(a)
                    acc[key] = acc.get(key, 0) + (b - a)
            prev = max(prev, e)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def summary(self) -> str:
        if not self.ops:
            return "no device events"
        first = min(s for _, s, _ in self.ops) - self.t0
        last = max(e for _, _, e in self.ops) - self.t0
        return (f"{len(self.ops)} device events from {first * 1e-9:.4f} s "
                f"to {last * 1e-9:.4f} s of a {self.window_s:.4f} s "
                f"stretch; {len(self.steps)} steps, {len(self.calls)} model "
                f"calls; busy {self.busy_s:.6f} s")
