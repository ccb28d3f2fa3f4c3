"""The port's JSON perf gate (``repro_torch.obs.regress``) against the
reference's ``repro.obs.regress``: on the same document pairs (the
committed ``BENCH_kernels.json`` and ``BENCH_pareto.json``, slowed, sped
up and reordered copies, and synthetic leaves) the same flattening,
gating directions, comparisons, exit codes and report lines -- the
counterparts of ``tests/test_profile.py``'s ``test_regress_*`` and of the
regress half of ``test_committed_pareto_baseline_gates``."""
import json
import os

import pytest

from repro.obs import regress as jregress
from repro_torch.obs import regress

REPO = os.path.join(os.path.dirname(__file__), "..")


def _both(capsys, argv):
    """(exit code, stdout) of the reference's and the port's main."""
    rc_j = jregress.main(argv)
    out_j = capsys.readouterr().out
    rc_t = regress.main(argv)
    out_t = capsys.readouterr().out
    return (rc_j, out_j), (rc_t, out_t)


def _scaled(doc, factor):
    doc = json.loads(json.dumps(doc))
    for r in doc["rows"]:
        if "us_per_call" in r:
            r["us_per_call"] = {k: v * factor
                                for k, v in r["us_per_call"].items()}
    return doc


@pytest.mark.parametrize("case", ["self", "slow", "fast", "slow_list",
                                  "pareto_self", "pareto_reversed"])
def test_regress_main_equals_reference(case, tmp_path, capsys):
    kern = os.path.join(REPO, "BENCH_kernels.json")
    pareto = os.path.join(REPO, "BENCH_pareto.json")
    if case.startswith("pareto"):
        doc = json.load(open(pareto))
        if case == "pareto_reversed":
            doc = dict(doc, points=list(reversed(doc["points"])))
        cur = str(tmp_path / "cur.json")
        json.dump(doc, open(cur, "w"))
        argv = [cur, pareto, "--tolerance", "0.5"]
    elif case == "self":
        argv = [kern, kern]
    else:
        factor = 1 / 9.0 if case == "fast" else 3.0
        cur = str(tmp_path / "cur.json")
        json.dump(_scaled(json.load(open(kern)), factor), open(cur, "w"))
        argv = [cur, kern, "--tolerance", "0.5"] + (
            ["--list"] if case == "slow_list" else [])
    ref, port = _both(capsys, argv)
    assert port == ref
    assert port[0] == (1 if case.startswith("slow") else 0)


def test_regress_flatten_compare_and_directions_equal_reference():
    doc = json.load(open(os.path.join(REPO, "BENCH_pareto.json")))
    shuffled = dict(doc, points=list(reversed(doc["points"])))
    assert regress.flatten(doc) == jregress.flatten(doc)
    assert regress.flatten(shuffled) == regress.flatten(doc)
    assert regress.compare(doc, shuffled, 0.0) \
        == jregress.compare(doc, shuffled, 0.0)
    kern = json.load(open(os.path.join(REPO, "BENCH_kernels.json")))
    slow = _scaled(kern, 3.0)
    assert regress.compare(slow, kern, 0.5) \
        == jregress.compare(slow, kern, 0.5)
    paths = set(regress.flatten(kern)) | set(regress.flatten(doc)) | {
        "rows.k/s.us_per_call.min", "rows.k/s.us_per_call.std",
        "virtual.ttft_s.p50", "throughput.tok_per_s", "a.queue_wait_s",
        "x.count", "stats.wall_s", "pareto.rate_rps", "b.hit_rate"}
    for p in sorted(paths):
        assert regress._direction(p) == jregress._direction(p), p


@pytest.mark.parametrize("cur,base,tol", [
    ({"throughput_tok_per_s": 1.0}, {"throughput_tok_per_s": 3.0}, 0.5),
    ({"throughput_tok_per_s": 9.0}, {"throughput_tok_per_s": 3.0}, 0.5),
    ({"rows": [{"kernel": "k1", "shape": "s", "us_per_call": {"min": 1}},
               {"kernel": "k2", "shape": "s", "us_per_call": {"min": 5}}]},
     {"rows": [{"kernel": "k2", "shape": "s", "us_per_call": {"min": 5}},
               {"kernel": "k1", "shape": "s", "us_per_call": {"min": 1}}]},
     0.1),
    ({"stages": {"decode": {"share": 0.9, "wall_s": 2.0}}},
     {"stages": {"decode": {"share": 0.1, "wall_s": 1.0}}}, 0.5),
])
def test_regress_compare_equals_reference_on_synthetic_docs(cur, base, tol):
    assert regress.compare(cur, base, tol) == jregress.compare(cur, base, tol)
    for p in ("wall.throughput_tok_per_s", "stages.decode.share",
              "schema_version", "profile.sites.compress.wall_self_s",
              "requests"):
        assert regress._direction(p) == jregress._direction(p)
