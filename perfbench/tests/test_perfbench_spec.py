"""The benchmark is driven by data: every cell, configuration, traffic mix
and metric of ``BENCHMARK.json`` is a file found by name, and a new cell
is added without editing a file that is there."""
from __future__ import annotations

import json
import re
import shutil

import pytest

import perfbench_testlib as lib
from harness import spec

with open(lib.ROOT / "BENCHMARK.json") as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = spec.load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (c["config"], c["traffic"], c["chips"]) == \
        (w["config"], w["traffic"], w["chips"])
    assert c["why"] == w["why"] and len(w["why"]) <= 200
    e2e = [m["name"] for m in spec.cell_metrics(cell, False)]
    layer = spec.cell_metrics(cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    path = lib.ROOT / cfg["file"]
    with open(path) as f:
        data = json.load(f)
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in data
        assert not key.endswith(("_dim", "_rank", "_size"))


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    for sub in ("configs", "traffic", "cells"):
        shutil.copytree(lib.BENCH / sub, tmp_path / sub)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*.json")}
    mix = {"loop": "closed", "clients": 16, "ramp_s": 2.0,
           "lengths": {"text": {"dist": "uniform", "lo": 64, "hi": 128},
                       "output": {"dist": "uniform", "lo": 8, "hi": 16}}}
    (tmp_path / "traffic" / "short_16.json").write_text(json.dumps(mix))
    cell = {"config": "qwen2-vl-2b", "traffic": "short_16", "chips": 1,
            "engine": {"max_batch": 16}, "why": "short prompts",
            "check": {"sample_tokens": 64, "sample_requests": 4,
                      "limits": {"gap_mean": 0.001}}}
    (tmp_path / "cells" / "qwen2vl-short.json").write_text(json.dumps(cell))
    got = spec.load_cell("qwen2vl-short", tmp_path)
    assert got["mix"] == mix and got["cfg"]["hidden_size"] == 1536
    assert all(p.read_bytes() == b for p, b in before.items())
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "qwen2vl-short", "config": "qwen2-vl-2b",
         "traffic": "short_16", "chips": 1, "why": "short prompts"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    names = [m["name"] for m in spec.cell_metrics(
        "qwen2vl-short", False, tmp_path / "BENCHMARK.json")]
    assert names == ["output_tok_s", "setup_s"]
