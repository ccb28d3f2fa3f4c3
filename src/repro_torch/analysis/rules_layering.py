"""L-rules: architecture layering (ROADMAP "Standing layering rules").

Port of ``repro.analysis.rules_layering``, keyed to the port's package:

L001  ``repro_torch.core.*`` imports outside ``src/repro_torch`` (and
      the port's tests and ``chip_smoke.py``) -- other code goes through
      the ``repro_torch.api`` facade. A micro-benchmark may keep a core
      import with an explicit waiver:
      ``# analysis: allow L001 (micro-bench)``.
L002  ``EngineConfig.compression`` mutated outside the port's api and
      core -- the facade registers named strategies instead.
L003  ``Engine(...)`` constructed outside ``src/repro_torch`` (and the
      port's tests and ``chip_smoke.py``) -- external layers use
      ``LVLM.serve*``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.tables import (COMPRESSION_MUTATION_OK_PREFIXES,
                                         ENGINE_CONSTRUCTION_OK_PREFIXES,
                                         INTERNAL_IMPORT_OK_PREFIXES)


CORE = "repro_torch.core"


def _under(path: str, prefixes) -> bool:
    return any(path.startswith(p) for p in prefixes)


@register
class CoreImportRule(Rule):
    rule_id = "L001"
    family = "L"
    severity = "error"
    description = ("repro_torch.core.* import outside src/repro_torch "
                   "(use the repro_torch.api facade)")

    def applies(self, path: str) -> bool:
        return not _under(path, INTERNAL_IMPORT_OK_PREFIXES)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            mod = None
            if isinstance(node, ast.ImportFrom) and node.module:
                mod = node.module
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.startswith(CORE):
                        mod = alias.name
                        break
            if mod and mod.startswith(CORE):
                out.append(self.finding(
                    path, node.lineno,
                    f"imports internal layer `{mod}`; route through "
                    "`repro_torch.api` (or waive: "
                    "# analysis: allow L001 (...))"))
        return out


@register
class CompressionMutationRule(Rule):
    rule_id = "L002"
    family = "L"
    severity = "error"
    description = ("EngineConfig.compression mutated outside the facade "
                   "(register a CompressionStrategy instead)")

    def applies(self, path: str) -> bool:
        return not _under(path, COMPRESSION_MUTATION_OK_PREFIXES)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for fn_or_mod in ast.walk(tree):
            body = getattr(fn_or_mod, "body", None)
            if not isinstance(fn_or_mod, (ast.Module, ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                continue
            # locals bound from EngineConfig(...) in this scope
            ec_names = {"ec", "engine_cfg"}
            for stmt in ast.walk(fn_or_mod):
                if isinstance(stmt, ast.Assign) \
                        and isinstance(stmt.value, ast.Call) \
                        and isinstance(stmt.value.func, ast.Name) \
                        and stmt.value.func.id == "EngineConfig":
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            ec_names.add(t.id)
            for stmt in body or ():
                for node in ast.walk(stmt):
                    if not isinstance(node, (ast.Assign, ast.AugAssign)):
                        continue
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        if not (isinstance(t, ast.Attribute)
                                and t.attr == "compression"):
                            continue
                        base = t.value
                        is_ec = (isinstance(base, ast.Name)
                                 and base.id in ec_names)
                        is_ec = is_ec or (isinstance(base, ast.Attribute)
                                          and base.attr in ec_names)
                        is_ec = is_ec or (isinstance(base, ast.Call)
                                          and isinstance(base.func, ast.Name)
                                          and base.func.id == "EngineConfig")
                        if is_ec:
                            out.append(self.finding(
                                path, node.lineno,
                                "mutates EngineConfig.compression outside "
                                "the facade; pass a CompressionStrategy / "
                                "GenerationConfig.compression instead"))
        return out


@register
class EngineConstructionRule(Rule):
    rule_id = "L003"
    family = "L"
    severity = "error"
    description = ("Engine constructed outside src/repro_torch "
                   "(use LVLM.serve / serve_async / serve_cluster)")

    def applies(self, path: str) -> bool:
        return not _under(path, ENGINE_CONSTRUCTION_OK_PREFIXES)

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "Engine":
                out.append(self.finding(
                    path, node.lineno,
                    "constructs Engine directly; the public decode/serving "
                    "surface is LVLM (decoder.engine_decode and "
                    "CompressionStrategy run behind it)"))
        return out
