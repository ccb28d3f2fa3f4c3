"""R-rules: resource acquire/release pairing over the serving stack.

Port of ``repro.analysis.rules_resource``, a copy: the tables match by
path suffix, and the port's engine, server, router and controller keep
the reference's names.

R001  Release-completeness: the canonical release functions
      (``Engine._release_request``, ``AsyncLVLMServer.abort``,
      ``RouterStream._retire``) must contain EVERY release action in
      the API table -- deleting a single release call (e.g. the
      prefix-pin decrement) is a finding at the function def.
R002  Acquire-reaches-release (per-function CFG walk): for every
      acquire site in the table (slot bind, pin increment, retirement
      append), no path function-entry -> acquire -> exit may avoid all
      matching release/handoff sites. Built on ``cfg.build_cfg``; loops,
      branches, try/except/finally, and early returns are walked.
R003  Module pairing: resources acquired and released in different
      functions by design (server ``_streams``, router ``inflight``,
      admission ``_waiters``) must have at least one matching release
      site somewhere in the module.

The acquire/release API table lives in ``tables.py`` (``RESOURCES``,
``RELEASE_COMPLETENESS``); the runtime sanitizer
(``repro_torch.analysis.sanitizer``) confirms or refutes R-findings with
conservation asserts at engine step boundaries.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.cfg import ENTRY, EXIT, build_cfg, function_defs
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.tables import RELEASE_COMPLETENESS, RESOURCES


def _suffix_match(path: str, suffixes) -> bool:
    return any(path.endswith(s) for s in suffixes)


@register
class ReleaseCompletenessRule(Rule):
    rule_id = "R001"
    family = "R"
    severity = "error"
    description = ("canonical release function is missing a release "
                   "action from the acquire/release API table")

    def applies(self, path: str) -> bool:
        return _suffix_match(path, {p for p, _ in RELEASE_COMPLETENESS})

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for (suffix, fn_name), actions in RELEASE_COMPLETENESS.items():
            if not path.endswith(suffix):
                continue
            fns = [f for f in function_defs(tree) if f.name == fn_name]
            if not fns:
                out.append(self.finding(
                    path, 1, f"release function `{fn_name}` not found "
                    "(API table expects it)"))
                continue
            for fn in fns:
                stmts = [n for n in ast.walk(fn) if isinstance(n, ast.stmt)]
                for action in actions:
                    if not any(action.matcher(s) for s in stmts):
                        out.append(self.finding(
                            path, fn.lineno,
                            f"`{fn_name}` is missing release action: "
                            f"{action.name}"))
        return out


@register
class AcquireReleaseCFGRule(Rule):
    rule_id = "R002"
    family = "R"
    severity = "error"
    description = ("an acquire site has a control-flow path to a function "
                   "exit that avoids every matching release/handoff")

    def applies(self, path: str) -> bool:
        suffixes = set()
        for res in RESOURCES:
            if not res.module_pairing:
                suffixes.update(res.path_suffixes)
        return _suffix_match(path, suffixes)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for res in RESOURCES:
            if res.module_pairing or not _suffix_match(
                    path, res.path_suffixes):
                continue
            for fn in function_defs(tree):
                if fn.name in res.exempt_functions:
                    continue
                body_stmts = [n for n in ast.walk(fn)
                              if isinstance(n, ast.stmt) and n is not fn]
                acquires = [s for s in body_stmts if res.acquire(s)]
                if not acquires:
                    continue
                ok = set(s for s in body_stmts if res.release(s))
                if res.handoff is not None:
                    ok |= set(s for s in body_stmts if res.handoff(s))
                graph = build_cfg(fn)
                for acq in acquires:
                    if acq not in graph.succ:
                        continue        # nested def: out of this walk
                    reaches_acq = graph.path_avoiding(ENTRY, acq, ok)
                    leaks = graph.path_avoiding(acq, EXIT, ok - {acq})
                    if reaches_acq and leaks:
                        out.append(self.finding(
                            path, acq.lineno,
                            f"resource `{res.rid}` acquired here can reach "
                            f"a function exit of `{fn.name}` without a "
                            f"matching release ({res.description})"))
        return out


@register
class ModulePairingRule(Rule):
    rule_id = "R003"
    family = "R"
    severity = "error"
    description = ("a module acquires a handed-off resource but contains "
                   "no matching release site")

    def applies(self, path: str) -> bool:
        suffixes = set()
        for res in RESOURCES:
            if res.module_pairing:
                suffixes.update(res.path_suffixes)
        return _suffix_match(path, suffixes)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        stmts = [n for n in ast.walk(tree) if isinstance(n, ast.stmt)]
        for res in RESOURCES:
            if not res.module_pairing or not _suffix_match(
                    path, res.path_suffixes):
                continue
            acquires = [s for s in stmts if res.acquire(s)]
            if acquires and not any(res.release(s) for s in stmts):
                out.append(self.finding(
                    path, acquires[0].lineno,
                    f"resource `{res.rid}` is acquired in this module but "
                    f"never released here ({res.description})"))
        return out
