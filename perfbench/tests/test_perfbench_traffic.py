"""The traffic is a function of the seed, and every seed sends the same
work in another order."""
from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

import perfbench_testlib as lib
from harness import traffic

MIXES = sorted((lib.BENCH / "traffic").glob("*.json"))


def _mix(name):
    with open(lib.BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def test_quantiles_by_hand():
    u = {"dist": "uniform", "lo": 0, "hi": 100}
    assert traffic.quantiles(u, 4).tolist() == [12, 38, 62, 88]
    lg = {"dist": "loguniform", "lo": 1, "hi": 10000}
    # (i + 0.5) / 2 of the way in log space: 10 ** 1 and 10 ** 3
    assert traffic.quantiles(lg, 2).tolist() == [10, 1000]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345])
def test_open_schedule_is_the_seed_s(seed):
    mix = _mix("hires_image")
    a = traffic.open_schedule(mix, seed, 20)
    b = traffic.open_schedule(mix, seed, 20)
    assert a == b
    assert all(0 < r["due_s"] <= 20 for r in a)
    assert [r["due_s"] for r in a] == sorted(r["due_s"] for r in a)


def test_open_schedule_same_work_every_seed():
    mix = _mix("hires_image")
    a = traffic.open_schedule(mix, 1, 20)
    b = traffic.open_schedule(mix, 2, 20)
    assert len(a) == len(b) == round(mix["rate_per_s"] * 20)
    for dim in traffic.DIMS:
        assert Counter(r[dim] for r in a) == Counter(r[dim] for r in b)
    assert [r["visual"] for r in a] != [r["visual"] for r in b]
    ga = np.diff([0.0] + [r["due_s"] for r in a])
    gb = np.diff([0.0] + [r["due_s"] for r in b])
    assert sorted(np.round(ga, 9)) == sorted(np.round(gb, 9))


def test_blocks_hold_one_value_of_each_stratum():
    vals = np.arange(64)
    out = traffic.order(vals, 16, np.random.default_rng(3))
    assert sorted(out.tolist()) == vals.tolist()
    for j in range(0, 64, 16):
        assert sorted(v // 4 for v in out[j:j + 16]) == list(range(16))


@pytest.mark.parametrize("path", MIXES, ids=[p.stem for p in MIXES])
def test_every_mix_is_read_by_the_generator(path):
    with open(path) as f:
        mix = json.load(f)
    assert mix["loop"] in ("open_poisson", "closed")
    rng = np.random.default_rng(0)
    sizes = traffic.sizes(mix, 32, rng)
    for dim, d in mix["lengths"].items():
        assert all(d["lo"] <= s[dim] <= d["hi"] for s in sizes)


def test_closed_rounds_are_stratified_per_round():
    mix = _mix("chat_64")
    one = traffic.sizes(mix, 64, np.random.default_rng(1))
    two = traffic.sizes(mix, 64, np.random.default_rng(2))
    for dim in ("text", "output"):
        assert sorted(s[dim] for s in one) == sorted(s[dim] for s in two)
