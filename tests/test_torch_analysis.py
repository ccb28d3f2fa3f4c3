"""repro_torch.analysis held to repro.analysis, and the port's K-rules.

(a) Every L/R/A/O fixture of ``tests/test_analysis.py`` gives the same
    ``(rule, line, severity)`` set through both analyzers, the port's
    copy renamed ``repro.`` -> ``repro_torch.`` and ``src/repro/`` ->
    ``src/repro_torch/``. O002's fixtures are left out: the port has no
    O002, since none of its kernel bodies is Python.
(b) The reference tests' real-source mutants (a release action
    neutralized, the span or profiler closes renamed, a core import
    appended to an example), made on the port's engine, controller and
    server, trip the same rules and actions as on the reference's files;
    the port's own profiler sites (``engine.step``, the model calls,
    sampling) trip O003 besides, one finding each. The files whose only
    sites are the port's (the model's head, the server's fan-out) trip
    O003 on a leaked begin, in a fixture and in a mutant of each.
(c) The framework: waivers, the baseline, the CFG, E000 and the CLI.
(d) The K-rules on the committed kernel wrappers and ``.cu`` sources
    (clean), and one mutant per concern, built under ``tmp_path``, that
    trips its own rule and no other.
(e) The whole default tree lints clean.

AST only: no model is built and nothing is compiled.
"""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref
from repro.analysis.registry import rule_table as ref_rule_table
from repro_torch.analysis import (Baseline, Finding, analyze_file,
                                  analyze_source, parse_waivers,
                                  run_analysis, select_rules)
from repro_torch.analysis.__main__ import main as cli
from repro_torch.analysis.cfg import ENTRY, EXIT, build_cfg, function_defs
from repro_torch.analysis.findings import fence_lines
from repro_torch.analysis.registry import rule_table
from repro_torch.analysis.rules_kernels import binding_table

ROOT = Path(__file__).resolve().parents[1]
ENGINE = "core/serving/engine.py"
SERVER = "serving/server.py"
CONTROLLER = "control/controller.py"


def _port_src(src: str) -> str:
    return src.replace("repro.", "repro_torch.")


def _port_path(path: str) -> str:
    return path.replace("src/repro/", "src/repro_torch/")


def _keys(findings):
    return sorted((f.rule, f.line, f.severity) for f in findings)


# ------------------------------------------- (a) fixture parity, L/R/A/O --
CORE_IMPORT = """
    from repro.core.serving import Engine
    """
A002_HAZARD = """
    class S:
        async def pump(self):
            if self._streams:
                await self.tick()
                self._streams.pop(1, None)
    """
SPAN_OK = """
    class S:
        async def _admit(self, stream):
            if self.tracer.enabled:
                self.tracer.span_begin("admission_wait", 1)
            try:
                ok = await self.admission.admit(stream.request)
            except BaseException:
                if self.tracer.enabled:
                    self.tracer.span_abort(1)
                raise
            if not ok:
                if self.tracer.enabled:
                    self.tracer.span_end("admission_wait", 1)
                return
            if self.tracer.enabled:
                self.tracer.span_end("admission_wait", 1)
            self._wake.set()
    """
ENGINE_SPANS = """
    class Engine:
        def submit(self, req):
            self.tracer.span_begin("request", req.rid)

        def step(self):
            self.tracer.span_end("request", 1)
    """
PROFILE_OK = """
    class Engine:
        def _decode_iteration(self):
            if self.profiler.enabled:
                self.profiler.site_begin("decode:greedy")
            cost = self._launch()
            if cost is None:
                if self.profiler.enabled:
                    self.profiler.site_end("decode:greedy")
                return 0.0
            if self.profiler.enabled:
                self.profiler.site_end("decode:greedy", vt=cost)
            return cost
    """
R003_ACQUIRE = """
    class S:
        def register(self, rid, stream):
            self._streams[rid] = stream
    """

# (name, source, path in the reference's tree, rules, the rules it trips)
FIXTURES = [
    ("l001_example", CORE_IMPORT, "examples/demo.py", ["L001"], ["L001"]),
    ("l001_inside_src", CORE_IMPORT, "src/repro/api/lvlm.py", ["L001"], []),
    ("l001_tests", CORE_IMPORT, "tests/test_x.py", ["L001"], []),
    ("l001_waiver_above", """
    # analysis: allow L001 (micro-bench)
    from repro.core.serving import Engine
    """, "benchmarks/bench_x.py", ["L001"], []),
    ("l001_waiver_block", """
    # analysis: allow L001 (micro-bench: long justification that
    # continues on a second comment line before the import)
    from repro.core.kv_cache.budget import uniform_budgets
    """, "benchmarks/bench_x.py", ["L001"], []),
    ("l002_engineconfig", """
    from repro.api import EngineConfig
    cfg = EngineConfig(max_batch=2)
    cfg.compression = "framefusion-0.25"
    """, "examples/demo.py", ["L002"], ["L002"]),
    ("l002_per_request", """
    for r in reqs:
        r.compression = presets[i % len(presets)]
    """, "examples/demo.py", ["L002"], []),
    ("l003_scripts", "eng = Engine(model, params, cfg)\n", "scripts/run.py",
     ["L003"], ["L003"]),
    ("l003_facade", "eng = Engine(model, params, cfg)\n",
     "src/repro/api/lvlm.py", ["L003"], []),
    ("r002_handoff", """
    class E:
        def bind(self, req):
            slot = self._free_slot()
            req._slot = slot
            self.slot_req[slot] = req
    """, f"src/repro/{ENGINE}", ["R002"], []),
    ("r002_early_return", """
    class E:
        def bind(self, req):
            slot = self._free_slot()
            if req.cancelled:
                return
            self.slot_req[slot] = req
    """, f"src/repro/{ENGINE}", ["R002"], ["R002"]),
    ("r002_release_every_branch", """
    class E:
        def bind(self, req):
            slot = self._free_slot()
            if req.cancelled:
                self._release_request(req)
                return
            self.slot_req[slot] = req
    """, f"src/repro/{ENGINE}", ["R002"], []),
    ("r002_exception_handler", """
    class E:
        def bind(self, req):
            slot = self._free_slot()
            try:
                self.prefill(req)
            except RuntimeError:
                self._release_request(req)
                raise
            self.slot_req[slot] = req
    """, f"src/repro/{ENGINE}", ["R002"], []),
    ("r003_acquire_only", R003_ACQUIRE, f"src/repro/{SERVER}", ["R003"],
     ["R003"]),
    ("r003_paired", R003_ACQUIRE + """
        def drop(self, rid):
            self._streams.pop(rid, None)
    """, f"src/repro/{SERVER}", ["R003"], []),
    ("a001_sleep", """
    import time
    async def pump(self):
        time.sleep(0.1)
    """, f"src/repro/{SERVER}", ["A001"], ["A001"]),
    ("a001_alias", """
    from time import sleep as zzz
    async def pump(self):
        zzz(0.1)
    """, "src/x.py", ["A001"], ["A001"]),
    ("a001_sync_ok", """
    import time, asyncio
    def sync_fn():
        time.sleep(0.1)
    async def pump(self):
        await asyncio.sleep(0.1)
    """, "src/x.py", ["A001"], []),
    ("a002_hazard", A002_HAZARD, f"src/repro/{SERVER}", ["A002"], ["A002"]),
    ("a002_fenced", A002_HAZARD.replace(
        "self._streams.pop(1, None)",
        "# analysis: atomic-step (pop of own key is idempotent)\n"
        "            self._streams.pop(1, None)"),
     f"src/repro/{SERVER}", ["A002"], []),
    ("a002_before_await", """
    class S:
        async def pump(self):
            self._streams.pop(1, None)
            await self.tick()
    """, f"src/repro/{SERVER}", ["A002"], []),
    ("a003_dropped", """
    import asyncio
    def kick(loop):
        asyncio.create_task(work())
    """, "src/x.py", ["A003"], ["A003"]),
    ("a003_kept", """
    import asyncio
    def kick(loop):
        t = asyncio.create_task(work())
        return t
    """, "src/x.py", ["A003"], []),
    ("o001_guarded", SPAN_OK, f"src/repro/{SERVER}", ["O001"], []),
    ("o001_leaky_return", SPAN_OK.replace(
        """            if not ok:
                if self.tracer.enabled:
                    self.tracer.span_end("admission_wait", 1)
                return""",
        """            if not ok:
                return"""), f"src/repro/{SERVER}", ["O001"],
     ["O001", "O001"]),
    ("o001_module_pairing", ENGINE_SPANS, f"src/repro/{ENGINE}", ["O001"],
     []),
    ("o001_module_no_close", ENGINE_SPANS.replace(
        'self.tracer.span_end("request", 1)', "pass"),
     f"src/repro/{ENGINE}", ["O001"], ["O001"]),
    ("o003_guarded", PROFILE_OK, f"src/repro/{ENGINE}", ["O003"], []),
    ("o003_leaky", PROFILE_OK.replace(
        """            if cost is None:
                if self.profiler.enabled:
                    self.profiler.site_end("decode:greedy")
                return 0.0""",
        """            if cost is None:
                return 0.0"""), f"src/repro/{ENGINE}", ["O003"],
     ["O003", "O003"]),
    ("e000_syntax", "def broken(:\n", "src/x.py", None, ["E000"]),
]


@pytest.mark.parametrize("name,src,path,rules,trips", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_parity(name, src, path, rules, trips):
    """The reference's fixture at its path and the port's renamed copy
    give the same findings, under the fixture's rules and under all."""
    src = textwrap.dedent(src)
    for sel in (None, rules):
        want = ref.analyze_source(src, path, rules=sel)
        got = analyze_source(_port_src(src), _port_path(path), rules=sel)
        assert _keys(got) == _keys(want), (sel, got, want)
    assert sorted(f.rule for f in got) == trips


# ------------------------------------------ (b) mutant parity, real files --
def _neutralize(src, needle, nth=1):
    """Replace the ``nth`` line containing ``needle`` with ``pass`` at the
    same indentation (as ``tests/test_analysis.py`` does)."""
    lines = src.splitlines(keepends=True)
    seen = 0
    for i, line in enumerate(lines):
        if needle in line:
            seen += 1
            if seen == nth:
                indent = line[:len(line) - len(line.lstrip())]
                lines[i] = indent + "pass\n"
                return "".join(lines)
    raise AssertionError(f"needle not found: {needle!r} #{nth}")


def _mutate(src, ops):
    for op in ops:
        if op[0] == "pass":
            src = _neutralize(src, *op[1:])
        elif op[0] == "rename":
            src = src.replace(op[1], op[2])
        else:
            src = src + op[1]
    return src


SOURCE_SLOT_UNBIND = (
    [("pass", 'self.slot_req[ticket["slot"]] = None')],
    # the port's complete_export unbinds through a local `slot`
    [("pass", "self.slot_req[slot] = None", 2)])
CLOSES = [("rename", "span_end(", "span_noop("),
          ("rename", "span_abort(", "span_noop(")]

# (name, file, mutation (or (reference's, port's)), rules, rule + what the
# reference's test asserts of the findings)
MUTANTS = [
    ("slot_unbind", ENGINE, [("pass", "self.slot_req[slot] = None")],
     ["R001"], ("R001", "slot-unbind")),
    ("draft_row_release", ENGINE, [("pass", "release(slot)")], ["R001"],
     ("R001", "draft-row release")),
    ("prefix_pin_clear", ENGINE, [("pass", "r._prefix_pin = None")],
     ["R001"], ("R001", "prefix-pin clear")),
    ("prefix_pin_decrement", ENGINE,
     [("pass", "self._prefix_pins[key] = n"),
      ("pass", "self._prefix_pins.pop(key, None)")], ["R001"],
     ("R001", "decrement")),
    ("export_ticket_pop", ENGINE,
     [("pass", "ticket = self._exports.pop(rid)")], ["R001"],
     ("R001", "export-ticket pop")),
    ("running_list_removal", ENGINE,
     [("pass", "self.running.remove(req)")], ["R001"],
     ("R001", "running-list removal")),
    ("source_slot_unbind", ENGINE, SOURCE_SLOT_UNBIND, ["R001"],
     ("R001", "source-slot unbind")),
    ("slot_handoff", ENGINE, [("pass", "self.slot_req[slot] = req")],
     ["R002"], ("R002", "`slot`")),
    ("engine_span_closes", ENGINE, CLOSES, ["O001"], ("O001", "")),
    ("engine_span_abort", ENGINE, CLOSES[1:], ["R001"],
     ("R001", "trace span close on abort")),
    ("engine_span_end", ENGINE, CLOSES[:1], ["R001"],
     ("R001", "request-span close at retire")),
    ("engine_site_closes", ENGINE, [("rename", "site_end(", "site_noop(")],
     ["O003"], ("O003", "")),
    ("server_span_closes", SERVER, CLOSES, ["O001"], ("O001", "")),
    ("revert_compression", CONTROLLER,
     [("pass", "req.compression = orig_comp")], ["R001"],
     ("R001", "preferred-compression restore")),
    ("revert_decoder", CONTROLLER, [("pass", "req.decoder = orig_dec")],
     ["R001"], ("R001", "preferred-decoder restore")),
    ("revert_nv_invalidation", CONTROLLER,
     [("pass", "req.nv_compressed = None"),
      ("pass", "req.nv_compressed = None")], ["R001"],
     ("R001", "stamped-count invalidation")),
    ("override_pops", CONTROLLER,
     [("pass", "self._overrides.pop(req.rid, None)"),
      ("pass", "self._overrides.pop(req.rid, None)")], ["R001", "R003"],
     ("R003", "control_override")),
]


def _guarded_begins(src):
    """(lines, site argument's source) of every profiler site opened under
    an ``if ...enabled:`` guard: the guard's line and the call's, where a
    leaked begin is flagged."""
    out = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.If) and "enabled" in ast.unparse(node.test):
            for stmt in node.body:
                for call in ast.walk(stmt):
                    if isinstance(call, ast.Call) and \
                            getattr(call.func, "attr", "") == "site_begin":
                        out.append(((node.lineno, stmt.lineno),
                                    ast.unparse(call.args[0])))
    return out


def _port_only_site_lines(ref_src, port_src):
    """The lines of the port's sites that the reference's file lacks."""
    ref_args = {a for _, a in _guarded_begins(ref_src)}
    return {ln for lns, a in _guarded_begins(port_src) if a not in ref_args
            for ln in lns}


def _actions(findings):
    """(rule, severity, message) of each finding, the name of the function
    a leak path leaves masked: the port's engine opens its ``compress``
    site in ``_compress_visual``, the reference's inside its prefill."""
    return sorted((f.rule, f.severity,
                   re.sub(r"(in|of) `\w+`", r"\1 `...`", f.message))
                  for f in findings)


@pytest.mark.parametrize("name,rel,ops,rules,trip", MUTANTS,
                         ids=[m[0] for m in MUTANTS])
def test_mutant_parity_on_real_sources(name, rel, ops, rules, trip):
    """Each file is clean as committed; each mutant gives the same
    (rule, severity, message) findings on both trees (lines differ)."""
    ref_ops, port_ops = ops if isinstance(ops, tuple) else (ops, ops)
    ref_path, port_path = f"src/repro/{rel}", f"src/repro_torch/{rel}"
    ref_src = (ROOT / ref_path).read_text()
    port_src = (ROOT / port_path).read_text()
    assert analyze_source(port_src, port_path, rules=rules) == []
    want = ref.analyze_source(_mutate(ref_src, ref_ops), ref_path,
                              rules=rules)
    got = analyze_source(_mutate(port_src, port_ops), port_path,
                         rules=rules)
    own = _port_only_site_lines(ref_src, port_src) if "O003" in rules \
        else set()
    assert {f.line for f in got if f.line in own} == own
    assert _actions([f for f in got if f.line not in own]) == _actions(want)
    assert any(f.rule == trip[0] and trip[1] in f.message for f in got), got


PORT_SITE_FIXTURE = """
    def _layer(p, x, prof):
        if prof.enabled:
            prof.site_begin("model.attn")
        a = attend(p, x)
        if a is None:
            if prof.enabled:
                prof.site_end("model.attn")
            return x
        if prof.enabled:
            prof.site_end("model.attn")
        return x + a
    """
PORT_SITE_FILES = ["models/transformer.py", SERVER]


@pytest.mark.parametrize("rel", PORT_SITE_FILES)
def test_o003_flags_a_leaked_begin_in_the_port_only_scopes(rel):
    """A site closed on every path is clean in each file that gained one;
    the same site left open on the early return is flagged there."""
    path = f"src/repro_torch/{rel}"
    src = textwrap.dedent(PORT_SITE_FIXTURE)
    assert analyze_source(src, path, rules=["O003"]) == []
    leaky = textwrap.dedent(PORT_SITE_FIXTURE.replace("""        if a is None:
            if prof.enabled:
                prof.site_end("model.attn")
            return x""", """        if a is None:
            return x"""))
    assert leaky != src
    got = analyze_source(leaky, path, rules=["O003"])
    assert [(f.rule, f.line) for f in got] == [("O003", 3), ("O003", 4)]
    assert analyze_source(leaky, "src/repro_torch/models/mamba.py",
                          rules=["O003"]) == []


@pytest.mark.parametrize("rel", PORT_SITE_FILES)
def test_port_only_site_closes_renamed_trip_o003(rel):
    """Each file that gained a site is clean as committed; with its
    ``site_end`` calls renamed, every one of its sites is flagged."""
    path = f"src/repro_torch/{rel}"
    src = (ROOT / path).read_text()
    assert analyze_source(src, path, rules=["O003"]) == []
    got = analyze_source(src.replace("site_end(", "site_noop("), path,
                         rules=["O003"])
    assert sorted(f.line for f in got) == \
        sorted(ln for lns, _ in _guarded_begins(src) for ln in lns)
    assert got and all(f.rule == "O003" for f in got)


def test_core_import_appended_to_an_example_trips_l001():
    src = (ROOT / "examples/stream_video.py").read_text()
    path = "examples/stream_video.py"
    want = ref.analyze_source(
        src + "\nfrom repro.core.serving import Engine\n", path)
    got = analyze_source(
        src + "\nfrom repro_torch.core.serving import Engine\n", path)
    assert _keys(got) == _keys(want) and [f.rule for f in got] == ["L001"]
    # the reference's core import is no port core import, and vice versa
    assert analyze_source(src + "\nfrom repro.core import x\n", path) == []


def test_facade_waivers_hold_under_the_port_l003():
    """The facade's two L003 waivers cover its two ``Engine(...)``
    constructions wherever the file is linted; without them a copy
    outside the package trips L003 twice."""
    src = (ROOT / "src/repro_torch/api/lvlm.py").read_text()
    assert analyze_source(src, "src/repro_torch/api/lvlm.py") == []
    assert analyze_source(src, "examples/lvlm_copy.py", rules=["L003"]) == []
    bare = src.replace("# analysis: allow L003", "# no waiver:")
    fs = analyze_source(bare, "examples/lvlm_copy.py", rules=["L003"])
    assert [f.rule for f in fs] == ["L003", "L003"]


# ---------------------------------------------------------- (c) framework --
def test_select_rules_families_and_ids():
    assert set(select_rules(["L"])) == {"L001", "L002", "L003"}
    assert set(select_rules(["R002", "A"])) == {"R002", "A001", "A002",
                                                "A003"}
    assert set(select_rules(["O"])) == {"O001", "O003"}
    assert set(select_rules(["K"])) == {"K001", "K002", "K003", "K004"}
    with pytest.raises(ValueError):
        select_rules(["O002"])


def test_list_rules_ids_are_the_reference_ids_but_o002(capsys):
    assert cli(["--list-rules"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("#") and "O002" in out[0]
    ids = [ln.split()[0] for ln in out[1:]]
    assert ids == [r["id"] for r in rule_table()]
    assert set(ids) == {r["id"] for r in ref_rule_table()} - {"O002"}


def test_waivers_and_fences():
    waived = parse_waivers("x = 1  # analysis: allow L001, A002 (legacy)\n")
    assert waived[1] == {"L001", "A002"}
    src = ("# analysis: atomic-step (safe:\n"
           "# own entry only)\n"
           "self._waiters.remove(e)\n")
    assert fence_lines(src) >= {1, 2, 3}


def test_baseline_roundtrip_and_line_slack(tmp_path):
    f = Finding(path="a.py", line=10, rule="L001", severity="error",
                message="m")
    p = tmp_path / "baseline.json"
    Baseline([f]).save(str(p))
    loaded = Baseline.load(str(p))
    near = Finding(path="a.py", line=15, rule="L001", severity="error",
                   message="moved")
    far = Finding(path="a.py", line=40, rule="L001", severity="error",
                  message="new")
    assert loaded.is_baselined(near)
    assert loaded.filter([near, far]) == [far]


def test_cfg_loop_break_and_finally_paths():
    src = textwrap.dedent("""
    def f(xs):
        acc = 0
        for x in xs:
            if x < 0:
                break
            acc += x
        try:
            return acc
        finally:
            log(acc)
    """)
    fn = next(iter(function_defs(ast.parse(src))))
    g = build_cfg(fn)
    stmts = {s.lineno: s for s in g.succ if not isinstance(s, str)}
    assert not g.path_avoiding(ENTRY, EXIT, {stmts[11]})
    assert g.path_avoiding(ENTRY, EXIT, set())


def test_cli_exit_codes_json_and_baseline(tmp_path, capsys, monkeypatch):
    """0 when clean, 1 on findings; ``--format json``; a baseline written
    by ``--write-baseline`` waives what it holds."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "demo.py").write_text(
        "from repro_torch.core.serving import Engine\n")
    (tmp_path / "src" / "repro_torch" / "ok.py").write_text("x = 1\n")
    assert cli(["--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"findings": [], "baselined": 0, "files_checked": 1}
    assert cli(["--format", "json", "examples"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [(f["rule"], f["path"], f["line"]) for f in out["findings"]] == [
        ("L001", "examples/demo.py", 1)]
    assert cli(["examples", "--write-baseline"]) == 0
    assert (tmp_path / "analysis_baseline_torch.json").exists()
    capsys.readouterr()
    assert cli(["examples"]) == 0
    assert "0 finding(s) (1 baselined)" in capsys.readouterr().out
    assert cli(["examples", "--no-baseline"]) == 1


def test_cli_over_the_tree_without_jax():
    """``python -m repro_torch.analysis`` lints the port clean with JAX
    blocked and loads no module of the JAX package."""
    probe = ("import runpy, sys; sys.modules['jax'] = None\n"
             "sys.argv = ['repro_torch.analysis']\n"
             "try:\n"
             "    runpy.run_module('repro_torch.analysis', "
             "run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    leaked = [m for m in sys.modules if m == 'repro' or "
             "m.startswith('repro.')]\n"
             "    print('leaked', leaked, 'torch' in sys.modules)\n"
             "    raise\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro_torch.analysis: 0 finding(s) (0 baselined)" in out.stdout
    assert "leaked [] False" in out.stdout
    assert not (ROOT / "analysis_baseline_torch.json").exists()


# ----------------------------------------------------------- (d) K-rules --
KDIR = "src/repro_torch/kernels"
WRAPPERS = ("flash_attention", "paged_attention", "mla_attention")


def test_k_rules_clean_on_the_committed_wrappers():
    for name in WRAPPERS:
        assert analyze_file(str(ROOT / KDIR / f"{name}.py"), rules=["K"],
                            root=str(ROOT)) == []
    rows = binding_table(str(ROOT))
    assert sorted((r["lib"], r["symbol"], r["function"]) for r in rows) == [
        ("flash_attention", "flash_attention_fwd", "_lib"),
        ("flash_attention_bwd", "flash_attention_bwd", "_bwd_lib"),
        ("mla_attention", "mla_attention_fwd", "_lib"),
        ("paged_attention", "paged_attention_fwd", "_lib")]
    for r in rows:
        assert r["argtypes"] == r["c_params"] >= 19, r
        assert r["admitted"] == r["instantiated"], r
    assert {r["lib"]: r["admitted"] for r in rows}["mla_attention"] == [
        32, 512]


def test_k_rules_only_apply_to_the_wrappers():
    src = (ROOT / KDIR / "flash_attention.py").read_text()
    bad = src.replace("[ctypes.c_int] * 10", "[ctypes.c_int] * 9", 1)
    for path in ("src/repro_torch/models/attention.py",
                 "src/repro_torch/kernels/sub/flash_attention.py",
                 "src/repro/kernels/flash_attention.py"):
        assert analyze_source(bad, path, rules=["K"], root=str(ROOT)) == []


def _nth(src, old, new, n):
    """``src`` with the ``n``-th (1-based) occurrence of ``old`` replaced."""
    i = -1
    for _ in range(n):
        i = src.index(old, i + 1)
    return src[:i] + new + src[i + len(old):]


def _wrap_in_fallback(src):
    """The paged launch wrapped in ``try: ... except: return plain``."""
    tree = ast.parse(src)
    stmt = next(s for s in ast.walk(tree) if isinstance(s, ast.Assign)
                and isinstance(s.value, ast.Call)
                and isinstance(s.value.func, ast.Call)
                and getattr(s.value.func.func, "id", "") == "_lib")
    lines = src.splitlines(keepends=True)
    body = ["    " + ln for ln in lines[stmt.lineno - 1:stmt.end_lineno]]
    pad = " " * stmt.col_offset
    fallback = [f"{pad}try:\n", *body, f"{pad}except RuntimeError:\n",
                f"{pad}    return paged_attention_plain(q, k_pages, v_pages, "
                "block_table, seq_lens)\n"]
    return "".join(lines[:stmt.lineno - 1] + fallback
                   + lines[stmt.end_lineno:])


# (name, wrapper, mutation of its source, rule, severity, count)
K_MUTANTS = [
    ("k001_dropped_c_int", "flash_attention",
     lambda s: s.replace("[ctypes.c_int] * 10", "[ctypes.c_int] * 9", 1),
     "K001", "error", 1),
    ("k001_float_as_int", "mla_attention",
     lambda s: s.replace("[ctypes.c_float, ctypes.c_int, ctypes.c_void_p]",
                         "[ctypes.c_int, ctypes.c_int, ctypes.c_void_p]"),
     "K001", "error", 1),
    ("k001_pointer_to_int", "flash_attention",
     lambda s: _nth(s, "ctypes.POINTER(ctypes.c_longlong)",
                    "ctypes.POINTER(ctypes.c_int)", 2), "K001", "error", 1),
    ("k001_restype", "paged_attention",
     lambda s: s.replace("fn.restype = ctypes.c_int",
                         "fn.restype = ctypes.c_float"), "K001", "error", 1),
    ("k002_extra_argument", "paged_attention",
     lambda s: s.replace("pps, split, _DTYPES[q.dtype],",
                         "pps, split, 0, _DTYPES[q.dtype],"),
     "K002", "error", 1),
    ("k002_missing_argument", "flash_attention",
     lambda s: s.replace("splits, int(h // kvh > BWD_HILO_G),",
                         "int(h // kvh > BWD_HILO_G),"), "K002", "error", 1),
    ("k003_head_dim_256", "flash_attention",
     lambda s: s.replace("HEAD_DIMS = (32, 64, 128, 192)",
                         "HEAD_DIMS = (32, 64, 128, 192, 256)"),
     "K003", "error", 2),                  # the forward's and backward's
    ("k003_latent_rank", "mla_attention",
     lambda s: s.replace("SHAPES = ((32, 16), (512, 64))",
                         "SHAPES = ((32, 16), (512, 64), (256, 32))"),
     "K003", "error", 1),
    ("k003_head_dim_pair", "flash_attention",
     lambda s: s.replace("(192, 192), (192, 128))",
                         "(192, 192), (192, 128), (192, 64))"),
     "K003", "error", 1),                  # the forward's pairs only
    ("k003_pair_instantiated_not_admitted", "flash_attention",
     lambda s: s.replace("(192, 192), (192, 128))", "(192, 192))"),
     "K003", "warning", 1),
    ("k003_instantiated_not_admitted", "paged_attention",
     lambda s: s.replace("HEAD_DIMS = (32, 64, 128, 192)",
                         "HEAD_DIMS = (32, 64, 128)"), "K003", "warning", 1),
    ("k004_code_discarded", "mla_attention",
     lambda s: s.replace("err = _lib()(", "_lib()("), "K004", "error", 1),
    ("k004_fallback_in_try", "paged_attention", _wrap_in_fallback,
     "K004", "error", 2),                  # the handler, and its return
    ("k004_logged_not_raised", "flash_attention",
     lambda s: s.replace('raise RuntimeError(f"flash_attention kernel '
                         'launch failed',
                         'print(f"flash_attention kernel launch failed'),
     "K004", "error", 1),
]


@pytest.fixture
def ktree(tmp_path):
    """A copy of the kernel wrappers and their sources under tmp_path."""
    dst = tmp_path / KDIR
    shutil.copytree(ROOT / KDIR / "csrc", dst / "csrc")
    for name in WRAPPERS:
        shutil.copy(ROOT / KDIR / f"{name}.py", dst / f"{name}.py")
    return tmp_path


@pytest.mark.parametrize("name,wrapper,mutate,rule,severity,count",
                         K_MUTANTS, ids=[m[0] for m in K_MUTANTS])
def test_k_mutant_trips_its_own_rule(ktree, name, wrapper, mutate, rule,
                                     severity, count):
    fp = ktree / KDIR / f"{wrapper}.py"
    assert analyze_file(str(fp), root=str(ktree)) == []
    src = fp.read_text()
    mutant = mutate(src)
    assert mutant != src
    fp.write_text(mutant)
    fs = analyze_file(str(fp), root=str(ktree))
    assert [(f.rule, f.severity) for f in fs] == [(rule, severity)] * count, \
        fs
    assert all(f.path == f"{KDIR}/{wrapper}.py" for f in fs)


@pytest.mark.parametrize("what,lib,mutate,rules", [
    ("no_cu", "paged_attention", None, {"K001", "K003"}),
    ("function_pointer_parameter", "mla_attention",
     lambda s: s.replace("int dtype, void* stream) {",
                         "int dtype, int (*cb)(int), void* stream) {"),
     {"K001"}),
    ("switch_instead_of_ternaries", "flash_attention",
     lambda s: s.replace("D == ", "D <= "), {"K003"}),
])
def test_k_rules_fail_loudly_where_they_cannot_read(ktree, what, lib, mutate,
                                                    rules):
    """A ``.cu`` the regex cannot read is an error finding, not a pass."""
    cu = ktree / KDIR / "csrc" / f"{lib}.cu"
    if mutate is None:
        cu.unlink()
    else:
        cu.write_text(mutate(cu.read_text()))
    fs = analyze_file(str(ktree / KDIR / f"{lib}.py"), root=str(ktree))
    assert {f.rule for f in fs} == rules and fs, fs
    assert all(f.severity == "error" for f in fs)


# -------------------------------------------------------- (e) whole tree --
def test_port_tree_is_clean():
    report = run_analysis(root=str(ROOT))
    assert report.ok, report.render()
    assert report.files_checked > 100
