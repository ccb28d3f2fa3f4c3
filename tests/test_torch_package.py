"""Package boundary of the port: it imports with JAX blocked and loads no
module of the JAX package; its entry points refuse to run on the CPU
unless asked to."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                    # any jax import now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "jaxlib" not in sys.modules
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20          # every module was imported


def test_chip_smoke_imports_nothing_of_jax_or_reference():
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert not {m for m in mods if m.split(".")[0] in ("jax", "repro")}


def test_from_pretrained_without_device_raises_without_cuda(monkeypatch):
    import torch
    from repro_torch.api import LVLM, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LVLM.from_pretrained("qwen2-vl-2b", smoke=True)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernels_are_built_only_on_demand():
    """Importing the kernel modules compiles nothing and needs no nvcc."""
    from repro_torch.kernels import build
    assert "flash_attention" in build.KERNELS
    assert build.library_path("flash_attention").suffix == ".so"
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()


def _assert_ported(path: str) -> None:
    """``path`` (under ``src/``'s packages) has its reference, and its port
    imports neither JAX nor the JAX package."""
    import ast
    assert (ROOT / "src" / "repro" / path).is_file()
    tree = ast.parse((ROOT / "src" / "repro_torch" / path).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert not {m for m in mods if m.split(".")[0] in ("jax", "repro")}


@pytest.mark.parametrize("name", ["selection", "budget", "merging", "paged",
                                  "prefix_cache", "tiered"])
def test_kv_cache_modules_are_ported(name):
    """Each module of the reference's ``core/kv_cache`` has its port,
    which imports neither JAX nor the JAX package (the probe above imports
    it with JAX blocked)."""
    _assert_ported(f"core/kv_cache/{name}.py")


@pytest.mark.parametrize("path", ["core/decoding/speculative.py",
                                  "core/decoding/early_exit.py",
                                  "api/decoders.py"])
def test_decoding_modules_are_ported(path):
    """Each module of the advanced-decoding slice has its reference and
    imports neither JAX nor the JAX package (the probe above imports it
    with JAX blocked)."""
    _assert_ported(path)
