"""The port's step builder and dry run (``launch.steps``, ``launch.dryrun``)
against the reference's, with nothing allocated.

* ``build_step`` for 10 archs x 4 shapes on the single-pod mesh: the
  step's name, every stand-in's shape and dtype (``meta`` tensors, the
  reference's ``ShapeDtypeStruct``s) and every in / out sharding equal
  the reference's ``LoweringSpec``.
* One ``run_pair`` (whisper-tiny decode_32k) in a subprocess on a fake
  process group of 256 ranks: an ``ok`` record with the reference's
  fields.
* The kernel wrappers take ``meta`` stand-ins to their plain versions.
* The four steps of qwen2-vl smoke and deepseek-v3 smoke on a 1x1 gloo
  mesh equal the same steps without a mesh (a subprocess: the mesh holds
  the process's default group).
* The committed grid (``experiments/dryrun_torch_*.json``, recorded on
  the card's host): 40 pairs per mesh, 1 skipped, every ``fail`` with its
  error -- the counterpart of ``test_dryrun_results_exist_and_pass``.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import ARCHS
from repro.launch import steps as jsteps
from repro.sharding import abstract_mesh as jabstract
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.steps import build_step
from repro_torch.roofline.analysis import RooflineReport
from repro_torch.sharding import abstract_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
SINGLE = ((16, 16), ("data", "model"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_equals_reference(arch, shape):
    jspec = jsteps.build_step(arch, shape, jabstract(*SINGLE))
    tspec = build_step(arch, shape, abstract_mesh(*SINGLE))
    if jspec is None:
        assert tspec is None
        return
    assert tspec.name == jspec.name
    assert len(tspec.args) == len(jspec.args)
    for ja, ta in zip(jspec.args, tspec.args):
        ja, ta = _flat(ja), _flat(ta)
        assert ja.keys() == ta.keys()
        for k in ja:
            assert tuple(ta[k].shape) == tuple(ja[k].shape), k
            assert str(ta[k].dtype) == f"torch.{ja[k].dtype}", k
            assert ta[k].device.type == "meta", k
    for jsh, tsh in ((jspec.in_shardings, tspec.in_shardings),
                     (jspec.out_shardings, tspec.out_shardings)):
        jl = jax.tree_util.tree_leaves(jsh)
        tl = jax.tree_util.tree_leaves(tsh,
                                       is_leaf=lambda x: hasattr(x, "spec"))
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            assert t.spec == tuple(j.spec)


def test_run_pair_in_a_fake_process_group(tmp_path):
    out = tmp_path / "pair.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "(256 devices)" in proc.stdout
    rec = json.load(open(out))["whisper-tiny|decode_32k"]
    assert rec["status"] == "ok"
    assert {"arch", "shape", "status", "step", "compile_s", "memory",
            "roofline"} <= set(rec)
    assert set(rec["roofline"]) == set(RooflineReport.__dataclass_fields__)
    assert rec["roofline"]["flops"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(
        v for k, v in mem.items() if k.endswith("_bytes")
        and k != "argument_bytes")
    assert "error" in mem and "peak_bytes" not in mem


def test_kernel_wrappers_take_meta_to_plain_versions():
    from repro_torch.kernels import ops
    m = dict(device="meta")
    o = ops.flash_attention(torch.empty(2, 8, 64, 32, **m),
                            torch.empty(2, 2, 64, 32, **m),
                            torch.empty(2, 2, 64, 32, **m))
    assert o.device.type == "meta" and tuple(o.shape) == (2, 8, 64, 32)
    pages = torch.empty(8, 16, 2, 32, **m)
    o = ops.paged_attention(torch.empty(2, 8, 32, **m), pages, pages,
                            torch.zeros(2, 4, dtype=torch.int32, **m),
                            torch.zeros(2, dtype=torch.int32, **m))
    assert o.device.type == "meta" and tuple(o.shape) == (2, 8, 32)


HOST_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_step, distribute_args,
                                          materialize, run_step)

    def tree(t, fn):
        if isinstance(t, dict):
            return {k: tree(v, fn) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(tree(v, fn) for v in t)
        return fn(t)

    def first(spec, out):
        t = out[2] if spec.name.endswith("/train") else out[0]
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    torch.set_num_threads(1)
    mesh = make_host_mesh("cpu")
    cuts = {"train_4k": dict(global_batch=2, seq_len=48),
            "prefill_32k": dict(global_batch=1, seq_len=64),
            "decode_32k": dict(global_batch=4, seq_len=64),
            "long_500k": dict(global_batch=1, seq_len=200)}
    res = {}
    for arch in sys.argv[1:]:
        for shape, cut in cuts.items():
            spec = build_step(arch, shape, mesh, smoke=True, **cut)
            args = materialize(spec, 0, "cpu")
            want = first(spec, spec.step(*tree(args, torch.clone)))
            got = first(spec, run_step(spec, distribute_args(spec, args)))
            res[arch + "|" + shape] = [
                float((got - want).abs().max()),
                max(1.0, float(want.abs().max()))]
    print("RESULT " + json.dumps(res))
""")


def test_host_mesh_steps_equal_plain_steps():
    proc = subprocess.run(
        [sys.executable, "-c", HOST_SCRIPT, "qwen2-vl-2b",
         "deepseek-v3-671b"],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[0][7:])
    assert len(res) == 8
    for key, (err, scale) in res.items():
        assert err <= 1e-3 * scale, (key, err, scale)


@pytest.mark.parametrize("tag", ["singlepod", "multipod"])
def test_committed_grid(tag):
    path = os.path.join(ROOT, "experiments", f"dryrun_torch_{tag}.json")
    with open(path) as f:
        results = json.load(f)
    assert len(results) == 40
    statuses = {k: v["status"] for k, v in results.items()}
    assert sum(1 for s in statuses.values() if s == "skipped") == 1
    assert set(statuses.values()) <= {"ok", "skipped", "fail"}
    for k, v in results.items():
        if v["status"] == "fail":
            assert v["error"], k
        if v["status"] == "ok":
            assert v["roofline"]["collective_counts"] is not None, k
