"""Analysis runner: walk paths, parse, run rules, waive, baseline.

Port of ``repro.analysis.runner``. ``analyze_source`` is the
test-friendly entry (lint a source string as if it lived at a given
repo-relative path); ``run_analysis`` is the CLI core (walk the port's
tree, apply a baseline if one was written, report). The port commits no
baseline: it lints clean.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, List, Optional, Sequence

from repro_torch.analysis.findings import (Baseline, Finding, apply_waivers)
from repro_torch.analysis.registry import select_rules

# The trees the port's rules govern (repo-relative): the port's package
# and its check on the card. The reference's ``python -m repro.analysis``
# goes on governing all of ``src/``.
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")
# written only by ``--write-baseline``; not committed
DEFAULT_BASELINE = "analysis_baseline_torch.json"

_SKIP_DIRS = {"__pycache__", ".git", ".github", "node_modules"}


def _norm(path: str, root: Optional[str]) -> str:
    """Repo-relative forward-slash path (rule scoping keys off it)."""
    if root:
        try:
            path = os.path.relpath(path, root)
        except ValueError:
            pass
    return path.replace(os.sep, "/")


def analyze_source(src: str, path: str, rules=None,
                   root: Optional[str] = None) -> List[Finding]:
    """Lint one source string as if it lived at repo-relative ``path``
    under ``root`` (default: the inferred repo root; the K-rules read
    the wrapper's ``csrc/<lib>.cu`` there). Waiver comments in ``src``
    are honored; the baseline is NOT applied (that is a run-level
    concern)."""
    selected = select_rules(rules)
    root = root or _infer_root()
    try:
        tree = ast.parse(src)
    except SyntaxError as exc:
        return [Finding(path=path, line=exc.lineno or 1, rule="E000",
                        severity="error",
                        message=f"syntax error: {exc.msg}")]
    findings: List[Finding] = []
    for rule in selected.values():
        if rule.applies(path):
            findings.extend(rule.run(tree, src, path, root))
    return sorted(apply_waivers(findings, src))


def analyze_file(path: str, rules=None,
                 root: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return analyze_source(src, _norm(path, root), rules=rules, root=root)


def _iter_py(paths: Sequence[str], root: str) -> Iterable[str]:
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            yield ap
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


@dataclasses.dataclass
class AnalysisReport:
    findings: List[Finding]            # non-baselined (the regressions)
    baselined: List[Finding]           # waived by the committed baseline
    files_checked: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"repro_torch.analysis: {len(self.findings)} finding(s) "
            f"({len(self.baselined)} baselined) across "
            f"{self.files_checked} file(s)")
        return "\n".join(lines)


def run_analysis(paths: Optional[Sequence[str]] = None, rules=None,
                 baseline: Optional[str] = DEFAULT_BASELINE,
                 root: Optional[str] = None) -> AnalysisReport:
    """Run the selected rules over ``paths`` (default: the governed
    trees) relative to ``root`` (default: cwd, or the repo root inferred
    from this file when cwd has no ``src/repro_torch``)."""
    root = root or _infer_root()
    paths = list(paths) if paths else [p for p in DEFAULT_PATHS
                                       if os.path.exists(
                                           os.path.join(root, p))]
    base = Baseline()
    if baseline:
        bp = baseline if os.path.isabs(baseline) \
            else os.path.join(root, baseline)
        if os.path.exists(bp):
            base = Baseline.load(bp)
    all_findings: List[Finding] = []
    n_files = 0
    for fp in _iter_py(paths, root):
        n_files += 1
        all_findings.extend(analyze_file(fp, rules=rules, root=root))
    fresh = base.filter(all_findings)
    waived = [f for f in all_findings if f not in fresh]
    return AnalysisReport(findings=sorted(fresh), baselined=waived,
                          files_checked=n_files)


def _infer_root() -> str:
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, "src", "repro_torch")):
        return cwd
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))
