"""What runs on the chip imports neither ``jax`` nor the JAX package
``repro``; the references import nothing of the program either. Module
names are compared by their top-level name as a whole word, so the port
``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

import perfbench_testlib as lib

JAX = {"jax", "jaxlib", "flax", "repro"}
CHIP_SIDE = sorted(p for p in lib.BENCH.rglob("*.py")
                   if "tests" not in p.relative_to(lib.BENCH).parts)
REFERENCE = sorted((lib.BENCH / "reference").glob("*.py"))


def tops(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".", 1)[0])
    return out


def test_whole_word_match():
    import run as bench
    assert bench.forbidden_modules(["repro_torch", "repro_torch.api",
                                    "reprojection", "jaxtyping"]) == []
    assert bench.forbidden_modules(["repro.api.lvlm", "jax.numpy",
                                    "flax"]) == ["flax", "jax", "repro"]


@pytest.mark.parametrize("path", CHIP_SIDE,
                         ids=[str(p.relative_to(lib.BENCH))
                              for p in CHIP_SIDE])
def test_chip_side_imports_no_jax(path):
    assert not tops(path) & JAX


@pytest.mark.parametrize("path", REFERENCE, ids=[p.stem for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    assert not tops(path) & (JAX | {"repro_torch", "harness"})


def test_a_run_loads_no_jax():
    """A whole CPU run in a fresh process: afterwards ``sys.modules``
    holds no jax, jaxlib, flax or repro (by top-level name)."""
    code = ("import perfbench_testlib as lib, run\n"
            "out = lib.cpu_run('tiny-qwen-open', seconds=0.3)\n"
            "print(out['correct'], run.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(lib.BENCH / "tests"),
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"
