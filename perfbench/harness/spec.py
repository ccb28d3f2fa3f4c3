"""Finding a cell's files by name, and the metrics a cell reports.

A workload name resolves to ``cells/<name>.json``, which names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``). The metrics a cell reports are the entries
of the root ``BENCHMARK.json`` that list the cell (or list no cells), and
each metric's number comes from ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    """The cell's own file, with its configuration and traffic mix loaded
    under ``cfg`` and ``mix``."""
    path = bench_dir / "cells" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"unknown workload {name!r}: no {path}")
    cell = _load_json(path)
    cell["name"] = name
    cell["cfg"] = _load_json(bench_dir / "configs" / f"{cell['config']}.json")
    cell["mix"] = _load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return cell


def cell_metrics(name: str, trace: bool,
                 bench_json: Path = ROOT / "BENCHMARK.json") -> List[Dict]:
    """The ``BENCHMARK.json`` metric entries this cell reports: its
    end-to-end metrics in an untraced run, its per-layer ones in a traced
    run."""
    bench = _load_json(bench_json)
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or name in m["workloads"]]


def metric_reader(metric: str) -> Callable:
    """``read(run) -> float | None`` from ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop_module(kind: str):
    """The loop kind ``traffic/<kind>.py`` (``drive(run, server)``)."""
    _on_path()
    return importlib.import_module(f"traffic.{kind}")


def reference_module(family: str):
    """The plain reference ``reference/<family>.py``."""
    _on_path()
    return importlib.import_module(f"reference.{family}")


def _on_path() -> None:
    if str(BENCH_DIR) not in sys.path:
        sys.path.insert(0, str(BENCH_DIR))
