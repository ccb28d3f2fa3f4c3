"""O-rules: repro_torch.obs trace-span pairing and profiler-site pairing.

Port of ``repro.analysis.rules_obs``, a copy of O001 and O003.

O001  Span pairing: every ``tracer.span_begin(...)`` site must reach a
      matching ``span_end``/``span_abort`` site. In per-function scopes
      (``serving/server.py``) this is the R002 CFG walk -- no path
      begin -> function exit may avoid every close, including the
      CancelledError / admission-retraction paths. In module-pairing
      scopes (``core/serving/engine.py``, where submit opens the span
      that step/abort close) the module must contain a close site, and
      the R001 entries in ``RELEASE_COMPLETENESS`` pin the specific
      closes to their functions.
O003  Profiler-site pairing: every ``profiler.site_begin(...)`` must
      reach a matching ``site_end`` on every CFG path of the SAME
      function (profiler sites measure a synchronous region, so unlike
      trace spans they never pair across function boundaries). A leaked
      begin corrupts the self/total attribution of every enclosing site.

The reference's O002 (no tracer emission inside a Pallas kernel body)
is not ported: the port's kernels are CUDA C++, so no kernel body of the
port is Python and the rule has nothing it could ever flag. Emission
from the host wrapper around a launch is what the port does throughout.

Site matching understands the ``if <x>.enabled:`` guard idiom: the
guard's ``if`` header is the CFG site, so the infeasible
"enabled at begin, disabled at close" branch combination is not
reported (every real path crosses the guard header).
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.cfg import ENTRY, EXIT, build_cfg, function_defs
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.tables import (PROFILE_BEGIN_CALLS,
                                         PROFILE_CLOSE_CALLS, PROFILE_SCOPES,
                                         SPAN_BEGIN_CALLS, SPAN_CLOSE_CALLS,
                                         SPAN_SCOPES, _own_nodes)


def _callee(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _subtree_calls(nodes: Iterable[ast.AST]) -> Iterable[str]:
    for root in nodes:
        for n in ast.walk(root):
            if isinstance(n, ast.Call):
                yield _callee(n)


def _is_enabled_guard(stmt: ast.stmt) -> bool:
    """``if <expr>.enabled:`` -- the tracer's zero-overhead gate."""
    return (isinstance(stmt, ast.If)
            and any(isinstance(n, ast.Attribute) and n.attr == "enabled"
                    for n in ast.walk(stmt.test)))


def _span_site(stmt: ast.stmt, names) -> bool:
    """``stmt`` emits one of ``names``: the call in its own expressions,
    or stmt is the ``if ...enabled:`` guard whose body holds the call
    (the guard header is the node every path crosses)."""
    if _is_enabled_guard(stmt):
        return any(c in names for c in _subtree_calls(stmt.body))
    return any(isinstance(n, ast.Call) and _callee(n) in names
               for n in _own_nodes(stmt))


def _pairing_findings(rule: Rule, tree: ast.AST, path: str, scopes,
                      begin_calls, close_calls, module_msg: str,
                      leak_msg: str) -> List[Finding]:
    """Shared begin/close pairing walk (O001 trace spans, O003 profiler
    sites): module-pairing scopes require at least one close site in the
    module; per-function scopes run the CFG walk -- no path from a begin
    site to the function exit may avoid every close site. Message
    templates take ``{fn}`` (function name) / ``{scope}`` (description)."""
    out: List[Finding] = []
    for scope in scopes:
        if not path.endswith(scope.path_suffix):
            continue
        if scope.module_pairing:
            stmts = [n for n in ast.walk(tree) if isinstance(n, ast.stmt)]
            begins = [s for s in stmts if _span_site(s, begin_calls)]
            if begins and not any(_span_site(s, close_calls)
                                  for s in stmts):
                out.append(rule.finding(
                    path, begins[0].lineno,
                    module_msg.format(scope=scope.description)))
            continue
        for fn in function_defs(tree):
            body = [n for n in ast.walk(fn)
                    if isinstance(n, ast.stmt) and n is not fn]
            begins = [s for s in body if _span_site(s, begin_calls)]
            if not begins:
                continue
            ok = {s for s in body if _span_site(s, close_calls)}
            graph = build_cfg(fn)
            for b in begins:
                if b not in graph.succ:
                    continue                # nested def: out of this walk
                reaches = graph.path_avoiding(ENTRY, b, ok)
                leaks = graph.path_avoiding(b, EXIT, ok - {b})
                if reaches and leaks:
                    out.append(rule.finding(
                        path, b.lineno, leak_msg.format(fn=fn.name)))
    return out


@register
class SpanPairingRule(Rule):
    rule_id = "O001"
    family = "O"
    severity = "error"
    description = ("a tracer span_begin site can reach a function exit "
                   "without a matching span_end/span_abort")

    def applies(self, path: str) -> bool:
        return any(path.endswith(s.path_suffix) for s in SPAN_SCOPES)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        return _pairing_findings(
            self, tree, path, SPAN_SCOPES, SPAN_BEGIN_CALLS,
            SPAN_CLOSE_CALLS,
            "module opens trace spans but contains no span_end/"
            "span_abort site -- every span it begins is an orphan "
            "({scope})",
            "span opened here in `{fn}` can reach a function exit "
            "without span_end/span_abort -- orphan span on that path")


@register
class ProfileSitePairingRule(Rule):
    rule_id = "O003"
    family = "O"
    severity = "error"
    description = ("a profiler site_begin can reach a function exit "
                   "without a matching site_end")

    def applies(self, path: str) -> bool:
        return any(path.endswith(s.path_suffix) for s in PROFILE_SCOPES)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        return _pairing_findings(
            self, tree, path, PROFILE_SCOPES, PROFILE_BEGIN_CALLS,
            PROFILE_CLOSE_CALLS,
            "module opens profiler sites but contains no site_end "
            "({scope})",
            "profiler site opened here in `{fn}` can reach a function "
            "exit without site_end -- the open frame corrupts self/"
            "total attribution for every later site")
