"""Findings, waiver comments, and the regression baseline.

Port of ``repro.analysis.findings``, a copy: the same ``Finding``,
``Baseline`` and waiver grammar.

A ``Finding`` is one rule violation at a file:line. Two suppression
mechanisms compose:

  * **waivers** -- ``# analysis: allow L001 (reason)`` on the offending
    line (or the line directly above it) waives that rule there, with
    the reason kept in the source as documentation. ``# analysis:
    atomic-step`` is the A002 fence variant (see rules_async.py).
  * **baseline** -- a committed JSON file of known findings; the runner
    reports only findings NOT in the baseline, so CI fails on
    regressions while pre-existing debt is paid down incrementally.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Set, Tuple

SEVERITIES = ("error", "warning", "info")

_WAIVE_RE = re.compile(
    r"#\s*analysis:\s*allow\s+([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)"
    r"(?:\s*\(([^)]*)\))?")
_FENCE_RE = re.compile(r"#\s*analysis:\s*atomic-step")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation. ``key`` (rule, path, line) is the baseline
    identity; ``message`` is for humans."""
    path: str
    line: int
    rule: str
    severity: str
    message: str

    @property
    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.path, self.line)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.severity}] {self.message}")

    def to_json(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "severity": self.severity, "message": self.message}

    @staticmethod
    def from_json(d: Dict) -> "Finding":
        return Finding(path=d["path"], line=int(d["line"]), rule=d["rule"],
                       severity=d.get("severity", "error"),
                       message=d.get("message", ""))


def _directive_span(lines: List[str], i: int) -> List[int]:
    """Lines covered by a directive comment at 1-based line ``i``: the
    directive's own line, any comment-only continuation lines below it,
    and the first code line after them (so a multi-line explanatory
    comment above a statement still covers the statement)."""
    span = [i]
    j = i + 1
    while j <= len(lines) and lines[j - 1].lstrip().startswith("#"):
        span.append(j)
        j += 1
    span.append(j)
    return span


def parse_waivers(src: str) -> Dict[int, Set[str]]:
    """Map line number -> set of waived rule ids. A waiver comment
    covers its own line, trailing comment lines, and the next code line
    (so a comment block above a multi-line statement waives it)."""
    lines = src.splitlines()
    waived: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _WAIVE_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",")}
        for line in _directive_span(lines, i):
            waived.setdefault(line, set()).update(rules)
    return waived


def fence_lines(src: str) -> Set[int]:
    """Lines carrying an ``# analysis: atomic-step`` fence (same span
    semantics as waivers: directive + comment block + next code line)."""
    lines = src.splitlines()
    out: Set[int] = set()
    for i, text in enumerate(lines, start=1):
        if _FENCE_RE.search(text):
            out.update(_directive_span(lines, i))
    return out


def apply_waivers(findings: List[Finding], src: str) -> List[Finding]:
    waived = parse_waivers(src)
    return [f for f in findings if f.rule not in waived.get(f.line, ())]


class Baseline:
    """Committed set of accepted findings; matching is by (rule, path)
    plus line with a small tolerance so unrelated edits above a
    baselined finding do not resurrect it."""

    LINE_SLACK = 10

    def __init__(self, findings: Optional[List[Finding]] = None):
        self.findings: List[Finding] = list(findings or [])

    @staticmethod
    def load(path: str) -> "Baseline":
        with open(path) as f:
            data = json.load(f)
        return Baseline([Finding.from_json(d)
                         for d in data.get("findings", [])])

    def save(self, path: str) -> None:
        data = {"version": 1,
                "findings": [f.to_json() for f in sorted(self.findings)]}
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")

    def is_baselined(self, finding: Finding) -> bool:
        for b in self.findings:
            if (b.rule == finding.rule and b.path == finding.path
                    and abs(b.line - finding.line) <= self.LINE_SLACK):
                return True
        return False

    def filter(self, findings: List[Finding]) -> List[Finding]:
        return [f for f in findings if not self.is_baselined(f)]
