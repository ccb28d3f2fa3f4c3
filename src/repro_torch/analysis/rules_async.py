"""A-rules: async hazards in the serving/cluster pumps.

Port of ``repro.analysis.rules_async``, a copy.

A001  Blocking call (``time.sleep``, sync subprocess, sync HTTP) inside
      ``async def`` -- stalls the event loop; the pump must use
      ``asyncio.sleep`` / executors.
A002  Shared mutable serving state (``_streams``, ``_waiters``,
      ``inflight``, engine queues -- see ``tables.SHARED_STATE_ATTRS``)
      read before an ``await`` and written after it in one async
      function: the await is a suspension point, another task may have
      mutated the structure in between. Deliberate, safe cases carry a
      ``# analysis: atomic-step`` fence on the write (documented
      evidence the re-read/idempotence was considered).
A003  Fire-and-forget ``create_task`` / ``ensure_future``: the returned
      task is dropped, so its exceptions vanish and it is collectable
      mid-flight; keep a reference or add a done-callback.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding, fence_lines
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.tables import (BLOCKING_CALLS, MUTATING_METHODS,
                                         SHARED_STATE_ATTRS)


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name of a call target ('time.sleep', 'sleep')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _async_defs(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


@register
class BlockingCallRule(Rule):
    rule_id = "A001"
    family = "A"
    severity = "error"
    description = "blocking call inside async def stalls the event loop"

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        # names imported `from time import sleep`-style
        bare: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for mod, name in BLOCKING_CALLS:
                    if node.module == mod:
                        for alias in node.names:
                            if alias.name == name:
                                bare[alias.asname or name] = f"{mod}.{name}"
        dotted = {f"{m}.{n}" for m, n in BLOCKING_CALLS}
        out: List[Finding] = []
        for fn in _async_defs(tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                target = _dotted(node.func)
                hit = target if target in dotted else bare.get(target)
                if hit:
                    out.append(self.finding(
                        path, node.lineno,
                        f"blocking `{hit}` inside async `{fn.name}`; use "
                        "asyncio.sleep / run_in_executor"))
        return out


@register
class AwaitSpanningMutationRule(Rule):
    rule_id = "A002"
    family = "A"
    severity = "warning"
    description = ("shared mutable state read before and written after an "
                   "await without an `# analysis: atomic-step` fence")

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        fences = fence_lines(src)
        out: List[Finding] = []
        for fn in _async_defs(tree):
            if fn.lineno in fences:
                continue                      # whole function fenced
            awaits = [n.lineno for n in ast.walk(fn)
                      if isinstance(n, ast.Await)]
            if not awaits:
                continue
            reads: Dict[str, List[int]] = {}
            writes: Dict[str, List[Tuple[int, int]]] = {}
            self._collect(fn, reads, writes)
            for attr, wlist in writes.items():
                for wline, _ in wlist:
                    if wline in fences:
                        continue
                    hazard = any(
                        r < a <= wline
                        for a in awaits for r in reads.get(attr, ()))
                    if hazard:
                        out.append(self.finding(
                            path, wline,
                            f"`{attr}` read before an await and mutated "
                            f"after it in async `{fn.name}`; re-check state "
                            "after suspension or fence with "
                            "`# analysis: atomic-step (why it is safe)`"))
                        break                 # one finding per attr per fn
        return out

    @staticmethod
    def _collect(fn: ast.AsyncFunctionDef, reads, writes) -> None:
        for node in ast.walk(fn):
            # attribute loads
            if isinstance(node, ast.Attribute) \
                    and node.attr in SHARED_STATE_ATTRS:
                if isinstance(node.ctx, ast.Load):
                    reads.setdefault(node.attr, []).append(node.lineno)
                else:
                    writes.setdefault(node.attr, []).append(
                        (node.lineno, node.col_offset))
            # subscript stores on a shared attr: self._streams[k] = v
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in SHARED_STATE_ATTRS \
                    and not isinstance(node.ctx, ast.Load):
                writes.setdefault(node.value.attr, []).append(
                    (node.lineno, node.col_offset))
            # mutating method calls: self._waiters.remove(...)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATING_METHODS \
                    and isinstance(node.func.value, ast.Attribute) \
                    and node.func.value.attr in SHARED_STATE_ATTRS:
                writes.setdefault(node.func.value.attr, []).append(
                    (node.lineno, node.col_offset))


@register
class FireAndForgetTaskRule(Rule):
    rule_id = "A003"
    family = "A"
    severity = "warning"
    description = ("create_task/ensure_future result dropped "
                   "(exceptions vanish; task is collectable mid-flight)")

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Expr):
                continue
            call = node.value
            if isinstance(call, ast.Call):
                name = _dotted(call.func)
                if name.endswith("create_task") \
                        or name.endswith("ensure_future"):
                    out.append(self.finding(
                        path, node.lineno,
                        "fire-and-forget task: keep the handle (or "
                        "add_done_callback) so failures surface"))
        return out
