"""Rule registry: rule ids -> checker instances, family selection.

Port of ``repro.analysis.registry``. A rule is a small class with
``rule_id``, ``family`` (L/R/A/K/O), ``severity``, ``description``, a
path filter (``applies``), and a ``check(tree, src, path) -> [Finding]``.
Registration is by decorator; ``select_rules`` accepts exact ids
("L001"), families ("R"), or "all". The runner calls ``run``, which
adds the repo root for the one family that reads a file beside the
linted one (the K-rules read a wrapper's ``csrc/<lib>.cu``).
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.findings import Finding

ALL_RULES: Dict[str, "Rule"] = {}
RULE_FAMILIES = ("L", "R", "A", "K", "O")


class Rule:
    rule_id = "X000"
    family = "X"
    severity = "error"
    description = ""

    def applies(self, path: str) -> bool:
        return True

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        raise NotImplementedError

    def run(self, tree: ast.AST, src: str, path: str,
            root: str) -> List[Finding]:
        """``check``, for a rule that needs no file but ``src``; ``root``
        is the directory that the repo-relative ``path`` lies under."""
        return self.check(tree, src, path)

    def finding(self, path: str, line: int, message: str,
                severity: str = None) -> Finding:
        return Finding(path=path, line=line, rule=self.rule_id,
                       severity=severity or self.severity, message=message)


def register(cls):
    inst = cls()
    if inst.rule_id in ALL_RULES:
        raise ValueError(f"duplicate rule id {inst.rule_id}")
    ALL_RULES[inst.rule_id] = inst
    return cls


def select_rules(spec=None) -> Dict[str, Rule]:
    """``spec``: None/"all", or iterable of rule ids and/or families."""
    _load()
    if spec in (None, "all", ("all",), ["all"]):
        return dict(ALL_RULES)
    out: Dict[str, Rule] = {}
    for item in spec:
        item = item.strip()
        if item in ALL_RULES:
            out[item] = ALL_RULES[item]
        elif item in RULE_FAMILIES:
            out.update({rid: r for rid, r in ALL_RULES.items()
                        if r.family == item})
        else:
            raise ValueError(
                f"unknown rule or family {item!r}; known: "
                f"{sorted(ALL_RULES)} / families {RULE_FAMILIES}")
    return out


def _load() -> None:
    """Import every rules module (registration is import-time)."""
    from repro_torch.analysis import (rules_async,  # noqa: F401
                                      rules_kernels, rules_layering,
                                      rules_obs, rules_resource)


def rule_table() -> List[Dict]:
    """[{id, family, severity, description}] for docs / --list-rules."""
    _load()
    return [{"id": r.rule_id, "family": r.family, "severity": r.severity,
             "description": r.description}
            for r in sorted(ALL_RULES.values(), key=lambda r: r.rule_id)]
