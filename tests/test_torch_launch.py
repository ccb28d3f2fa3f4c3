"""The port's serving CLI (``python -m repro_torch.launch.serve``) against
the reference's (``python -m repro.launch.serve``), on the CPU.

Both CLIs build their own smoke model from their own seed and serve the
same synthetic requests (numpy seeds); every number in their JSON
report lives on the virtual clock and, at temperature 0 with no eos,
does not depend on the weights, so the two reports are equal -- for a
plain run, a prefix-affinity fleet with a shared prefix, a
prefill/decode fleet (with its Prometheus text), an adaptive-control
run, and runs of the rwkv6-3b and zamba2-1.2b smoke models. The
training CLI (``python -m repro_torch.launch.train``) prints the
reference's ``done:`` line. ``--dry-run`` of either CLI runs the port's
dry run in a subprocess with the reference's arguments
(``repro_torch.launch.dryrun`` for ``repro.launch.dryrun``) and returns
its exit code.
"""
import json
import re
import sys

import pytest
import torch

import repro.launch.serve as jserve
import repro.launch.train as jtrain
import repro_torch.launch.serve as tserve
import repro_torch.launch.train as ttrain

COMMON = ["--requests", "4", "--new-tokens", "4"]
CASES = {
    "plain": [],
    "prefix_affinity": ["--arch", "phi4-mini-3.8b", "--replicas", "2",
                        "--routing", "prefix_affinity", "--prefix-cache",
                        "--shared-prefix", "32"],
    "roles": ["--roles", "prefill:1,decode:1", "--open-loop", "2000",
              "--metrics-out", "-"],
    "control": ["--control", "--open-loop", "2000", "--max-batch", "2"],
    "rwkv6": ["--arch", "rwkv6-3b"],
    "zamba2": ["--arch", "zamba2-1.2b"],
}


def _reference(args, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    assert jserve.main() == 0
    return capsys.readouterr().out


def _port(args, capsys):
    assert tserve.main(args + ["--device", "cpu"]) == 0
    return capsys.readouterr().out


def _last_json(out):
    """The report: the JSON object that ends the output."""
    return json.loads(out[out.rfind("\n{") + 1:])


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_report_equals_reference(case, monkeypatch, capsys):
    args = COMMON + CASES[case]
    ref = _reference(args, monkeypatch, capsys)
    port = _port(args, capsys)
    blob = _last_json(port)
    assert blob["finished"] == 4 and blob["tokens"] == 16
    if case == "roles":
        assert "repro_migrations_total 4" in port
    if case == "control":
        assert blob["control_overrides_open"] == 0
    assert blob == _last_json(ref)
    assert port == ref


def _delegated(monkeypatch, run, argv):
    """The command ``run()`` hands to ``subprocess.call`` (recorded, not
    run; it exits 7) and ``run``'s return value."""
    import subprocess
    calls = []

    def call(cmd, **kw):
        calls.append(list(cmd))
        return 7
    monkeypatch.setattr(subprocess, "call", call)
    monkeypatch.setattr(sys, "argv", argv)
    rc = run()
    assert len(calls) == 1
    return calls[0], rc


def _dry_run_delegates(monkeypatch, jmain, tmain, arch, extra=()):
    args = ["--dry-run"] + (["--arch", arch] if arch else [])
    ref, ref_rc = _delegated(monkeypatch, jmain, ["x"] + args)
    port, port_rc = _delegated(
        monkeypatch, lambda: tmain(args + list(extra)), ["x"])
    assert ref[1:3] == ["-m", "repro.launch.dryrun"]
    assert port[1:3] == ["-m", "repro_torch.launch.dryrun"]
    assert port[0] == ref[0] and port[3:] == ref[3:]
    assert port_rc == ref_rc == 7


def test_cli_refuses_dry_run_and_needs_a_device(capsys, monkeypatch):
    """(The dry run is no longer refused.) ``--dry-run`` delegates to the
    port's dry run with the reference's arguments and returns its exit
    code; without ``--device`` and without a card the serve CLI raises."""
    for arch in (None, "phi4-mini-3.8b"):
        _dry_run_delegates(monkeypatch, jserve.main, tserve.main, arch,
                           extra=("--device", "cpu"))
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(COMMON)


TRAIN_ARGS = ["--arch", "phi4-mini-3.8b", "--smoke", "--steps", "3",
              "--vocab", "128", "--batch", "2", "--seq", "16"]
DONE = re.compile(r"^done: loss (\d+\.\d{4}) -> (\d+\.\d{4}) in 3 steps "
                  r"\(\d+\.\ds\)$", re.M)


def test_train_cli_prints_the_reference_done_line(monkeypatch, capsys):
    # one intra-op thread: many small ops, and test workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train_cli_run(monkeypatch, capsys)
    finally:
        torch.set_num_threads(n)


def _train_cli_run(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + TRAIN_ARGS)
    assert jtrain.main() == 0
    ref = DONE.search(capsys.readouterr().out)
    assert ttrain.main(TRAIN_ARGS + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    port = DONE.search(out)
    assert ref and port, out
    assert out.splitlines()[0].startswith("step     0  loss ")
    assert float(port.group(2)) < float(port.group(1))


def test_train_cli_refuses_dry_run(capsys, monkeypatch):
    """(The dry run is no longer refused.) ``launch.train --dry-run``
    delegates to the port's dry run of train_4k with the reference's
    arguments and returns its exit code."""
    for arch in (None, "qwen2-vl-2b"):
        _dry_run_delegates(monkeypatch, jtrain.main, ttrain.main, arch,
                           extra=("--device", "cpu"))
