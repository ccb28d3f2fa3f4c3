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


@pytest.mark.parametrize("path", [
    "obs/stats.py", "obs/trace.py", "obs/perfetto.py", "obs/validate.py",
    "obs/profile.py", "obs/prom.py", "obs/__init__.py",
    "analysis/sanitizer.py", "serving/metrics.py", "serving/admission.py",
    "serving/server.py", "serving/__init__.py"])
def test_serving_and_observability_modules_are_ported(path):
    """Each module of the serving-and-observability slice has its
    reference, and imports neither JAX nor the JAX package, not even the
    JAX-free ``repro.obs`` (the probe above imports it with JAX blocked)."""
    _assert_ported(path)


def test_obs_validate_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.obs.validate`` checks a trace with JAX
    blocked."""
    trace = tmp_path / "t.jsonl"
    trace.write_text(
        '{"k": "B", "name": "request", "rid": 1, "rep": 0, "vt": 0.0, '
        '"wt": 0.0}\n{"k": "E", "name": "request", "rid": 1, "rep": 0, '
        '"vt": 0.1, "wt": 0.1}\n')
    probe = ("import sys, runpy; sys.modules['jax'] = None; "
             f"sys.argv = ['v', {str(trace)!r}]; "
             "runpy.run_module('repro_torch.obs.validate', "
             "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK (2 events" in out.stdout


@pytest.mark.parametrize("path", [
    "core/serving/disaggregation.py", "cluster/__init__.py",
    "cluster/policies.py", "cluster/prefix_tier.py", "cluster/metrics.py",
    "cluster/router.py", "control/__init__.py", "control/policy.py",
    "control/controller.py", "control/sweep.py", "launch/__init__.py",
    "launch/serve.py"])
def test_cluster_control_and_launch_modules_are_ported(path):
    """Each module of the cluster, disaggregation and control slice has
    its reference, and imports neither JAX nor the JAX package (the probe
    above imports it with JAX blocked)."""
    _assert_ported(path)


def test_serve_cli_runs_without_jax():
    """``python -m repro_torch.launch.serve`` parses its flags with JAX
    blocked (``--help`` lists the port's ``--device``)."""
    probe = ("import sys, runpy; sys.modules['jax'] = None; "
             "sys.argv = ['serve', '--help']; "
             "runpy.run_module('repro_torch.launch.serve', "
             "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--roles" in out.stdout


@pytest.mark.parametrize("path", [
    "models/moe.py", "configs/shapes.py", "configs/granite_34b.py",
    "configs/mistral_large_123b.py", "configs/nemotron_4_340b.py",
    "configs/arctic_480b.py", "configs/deepseek_v3_671b.py",
    "configs/rwkv6_3b.py", "configs/whisper_tiny.py",
    "configs/zamba2_1_2b.py", "models/resampler.py", "models/rwkv.py",
    "models/mamba.py"])
def test_architecture_modules_are_ported(path):
    """Each module of the other-architectures slice has its reference, and
    imports neither JAX nor the JAX package (the probe above imports it
    with JAX blocked)."""
    _assert_ported(path)


def test_every_arch_config_loads_without_jax():
    """All ten configs load and build (spec trees only) with JAX
    blocked."""
    probe = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "from repro_torch.models import build\n"
        "built = []\n"
        "for a in ARCHS:\n"
        "    cfg = get_config(a)\n"
        "    try:\n"
        "        build(cfg).param_specs(); built.append(a)\n"
        "    except NotImplementedError:\n"
        "        pass\n"
        "print(len(ARCHS), sorted(built))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'repro']")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == (
        "10 ['arctic-480b', 'deepseek-v3-671b', 'granite-34b', "
        "'mistral-large-123b', 'nemotron-4-340b', 'phi4-mini-3.8b', "
        "'qwen2-vl-2b', 'rwkv6-3b', 'whisper-tiny', 'zamba2-1.2b']")


def test_mla_kernel_module_imports_without_jax():
    """The latent kernel's module (a port-only kernel: the reference runs
    MLA's absorbed decode in jnp einsums, so there is no reference file to
    mirror) imports with JAX blocked, loads no module of the JAX package,
    builds nothing at import, and its C source is in the build list."""
    probe = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.kernels import build, mla_attention, ops\n"
        "assert 'mla_attention' in build.KERNELS\n"
        "assert (build.CSRC / 'mla_attention.cu').is_file()\n"
        "assert mla_attention.mla_attention.launches == 0\n"
        "assert ops.mla_attention is not None\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('repro', 'jaxlib')]\n"
        "print(mla_attention.SHAPES)")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "((32, 16), (512, 64))"


@pytest.mark.parametrize("path", [
    "training/__init__.py", "training/optimizer.py", "training/data.py",
    "training/checkpoint.py", "training/loop.py", "launch/train.py",
    "roofline/analytic.py", "roofline/hw.py"])
def test_training_modules_are_ported(path):
    """Each module of the training slice has its reference, and imports
    neither JAX nor the JAX package, not even the JAX-free
    ``repro.training.data`` or ``repro.roofline.analytic`` (the probe
    above imports it with JAX blocked)."""
    _assert_ported(path)


def test_train_cli_runs_without_jax():
    """``python -m repro_torch.launch.train`` parses its flags with JAX
    blocked (``--help`` lists the port's ``--device``)."""
    probe = ("import sys, runpy; sys.modules['jax'] = None; "
             "sys.argv = ['train', '--help']; "
             "runpy.run_module('repro_torch.launch.train', "
             "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--ckpt-every" in out.stdout


@pytest.mark.parametrize("path", [
    "analysis/__init__.py", "analysis/__main__.py", "analysis/cfg.py",
    "analysis/findings.py", "analysis/registry.py", "analysis/runner.py",
    "analysis/tables.py", "analysis/rules_layering.py",
    "analysis/rules_resource.py", "analysis/rules_async.py",
    "analysis/rules_kernels.py", "analysis/rules_obs.py"])
def test_analyzer_modules_are_ported(path):
    """Each module of the static analyzer has its reference, and imports
    neither JAX nor the JAX package, not even ``repro.analysis`` (the
    probe above imports it with JAX blocked)."""
    _assert_ported(path)


@pytest.mark.parametrize("path", [
    "sharding/__init__.py", "sharding/compat.py", "sharding/specs.py",
    "launch/mesh.py", "launch/steps.py", "launch/dryrun.py",
    "launch/train.py", "roofline/__init__.py", "roofline/analysis.py",
    "obs/regress.py"])
def test_sharding_and_roofline_modules_are_ported(path):
    """Each module of the sharding, dry-run and roofline slice has its
    reference, and imports neither JAX nor the JAX package (the probe
    above imports it with JAX blocked)."""
    _assert_ported(path)


def test_only_the_analyzer_and_hlo_walk_are_left():
    """A file-by-file comparison of the two trees leaves only
    ``roofline/hlo_cost``, whose place ``roofline/step_cost`` takes: the
    static analyzer (``analysis/*``) is ported beside its sanitizer."""
    ref = {p.relative_to(ROOT / "src" / "repro").as_posix()
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert ref - port == {"roofline/hlo_cost.py"}
    assert "roofline/step_cost.py" in port
    assert {p for p in ref if p.startswith("analysis/")} <= port


def test_importing_the_port_opens_no_process_group():
    probe = ("import importlib, pkgutil, sys; sys.modules['jax'] = None\n"
             "import torch.distributed as dist, repro_torch\n"
             "for m in pkgutil.walk_packages(repro_torch.__path__, "
             "'repro_torch.'):\n"
             "    importlib.import_module(m.name)\n"
             "assert not dist.is_initialized()\n"
             "from repro_torch.sharding.context import current\n"
             "assert current() is None\n")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
