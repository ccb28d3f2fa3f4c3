"""The port's roofline (``roofline.analysis``, ``roofline.step_cost``)
against the reference's.

* ``roofline_from_costs`` on the numbers the reference's
  ``roofline_from_compiled`` reads from a compiled module (its HLO walk
  and ``cost_analysis``) gives the reference's ``RooflineReport``, field
  for field, at the reference's TPU constants; ``model_flops_estimate``
  equals the reference's for every (arch x shape).
* ``collective_bytes`` weighs the five collectives as
  ``collective_bytes_from_hlo`` does on ``HLO_SAMPLE``'s shapes, and
  ``CollectiveRecorder`` records the four DTensor issues (kind, operand
  and output bytes) from ``_c10d_functional`` ops on a fake process group
  (``permute_tensor`` itself lowers to an all-to-all there).
* FLOPs: ``FlopCounterMode`` over the port's smoke prefill and decode on
  meta tensors equals ``walk_costs`` of the reference's single-device
  compile exactly (tolerance 0.1%). The prefill runs at 1024 positions:
  at shorter prompts the reference's ``blockwise_sdpa`` pads the keys to
  its 1024-key block, and its walk counts the padded products (phi4-mini
  smoke at batch 2 and 48 positions: 21x the attention products, +86% on
  the whole prefill), which the port's attention does not compute.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.models import build as jbuild
from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro.roofline.hlo_cost import walk_costs
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.steps import _abstract_tree
from repro_torch.models import build
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import HW

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FLOP_TOL = 1e-3

HLO_SAMPLE = """
ENTRY %main {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ag = f32[2048,256]{1,0} all-gather(f32[128,256]{1,0} %p0), dimensions={0}
  %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %ag2), to_apply=%add
  %rs = f32[8,256]{1,0} reduce-scatter(f32[128,256]{1,0} %ar), dimensions={0}
  %a2a = f32[128,256]{1,0} all-to-all(f32[128,256]{1,0} %rs), dimensions={0}
  %cp = f32[128,256]{1,0} collective-permute(f32[128,256]{1,0} %a2a)
  %dot = f32[128,128]{1,0} dot(f32[128,256] %cp, f32[256,128] %w)
}
"""
B = 128 * 256 * 4
# (kind, operand bytes, output bytes) of each collective in HLO_SAMPLE
SAMPLE_OPS = [("all-gather", B, 2048 * 256 * 4), ("all-reduce", B, B),
              ("reduce-scatter", B, 8 * 256 * 4), ("all-to-all", B, B),
              ("collective-permute", B, B)]


class _Compiled:
    """What ``roofline_from_compiled`` reads of a compiled module."""

    def __init__(self, hlo, nbytes):
        self.hlo, self.nbytes = hlo, nbytes

    def cost_analysis(self):
        return {"bytes accessed": self.nbytes}

    def as_text(self):
        return self.hlo

    def memory_analysis(self):
        raise NotImplementedError("CPU backend")


@pytest.mark.parametrize("chips,model_flops,analytic,nbytes", [
    (1, 0.0, 0.0, 1e6), (256, 4e12, 1e12, 2e9), (512, 1e9, 0.0, 5e10)])
def test_roofline_report_equals_reference(chips, model_flops, analytic,
                                          nbytes):
    hlo = HLO_SAMPLE
    want = janalysis.roofline_from_compiled(
        "s", _Compiled(hlo, nbytes), chips=chips, model_flops=model_flops,
        analytic_bytes=analytic)
    walk = walk_costs(hlo)
    got = analysis.roofline_from_costs(
        "s", {"flops": walk["flops"], "bytes_accessed": nbytes,
              "collective_bytes": walk["collective_bytes"],
              "collective_counts": walk["collective_counts"]},
        chips=chips, model_flops=model_flops, analytic_bytes=analytic,
        hw=HW(**dataclasses.asdict(jhw.TPU_V5E)))
    assert got.as_dict() == want.as_dict()
    assert set(dataclasses.asdict(got)) == set(dataclasses.asdict(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_equals_reference(arch):
    for name in SHAPES:
        assert analysis.model_flops_estimate(get_config(arch), SHAPES[name]) \
            == janalysis.model_flops_estimate(jget(arch), JSHAPES[name])


def test_collective_weights_equal_reference_parser():
    want = janalysis.collective_bytes_from_hlo(HLO_SAMPLE)
    got = analysis.collective_bytes(SAMPLE_OPS)
    assert got == want


RECORDER = textwrap.dedent("""
    import json, torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.roofline.analysis import collective_bytes
    from repro_torch.roofline.step_cost import CollectiveRecorder
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    g = dist.group.WORLD
    x = torch.empty(128, 256, device="meta")
    with CollectiveRecorder() as rec:
        fc.all_gather_tensor(x, 0, g)
        fc.all_reduce(x, "sum", g)
        fc.reduce_scatter_tensor(x, "sum", 0, g)
        fc.all_to_all_single(x, None, None, g)
    print("RESULT " + json.dumps([rec.ops, rec.unknown,
                                  collective_bytes(rec.ops)]))
""")


def test_recorder_sees_the_collectives():
    proc = subprocess.run([sys.executable, "-c", RECORDER],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    ops, unknown, weighted = json.loads(line[0][7:])
    assert unknown == {}
    assert [op[0] for op in ops] == [k for k, _, _ in SAMPLE_OPS[:4]]
    assert ops[0] == ["all-gather", B, 16 * B]       # output: 16 shards
    assert ops[2] == ["reduce-scatter", B, B / 16]
    want = 16 * B + 2 * B + B + B
    assert weighted["collective_bytes"] == want


def _jstruct(shape, dtype):
    return jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))


def _tmeta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "phi4-mini-3.8b"])
def test_smoke_flops_equal_reference_walk(arch, kind):
    jcfg = jget(arch, smoke=True)
    jm = jbuild(jcfg)
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    m = build(get_config(arch, smoke=True))
    tp = _abstract_tree(m.param_specs(), m.cfg.dtype)
    b, length = 2, 1024
    if kind == "prefill":
        nv = jcfg.num_visual_tokens if jcfg.family == "vlm" else 0
        shapes = {"tokens": ((b, length - nv), "int32")}
        if nv:
            shapes["visual_embeds"] = ((b, nv, jcfg.d_model), "float32")
        hlo = jax.jit(lambda p, bt: jm.prefill(
            p, bt, cache_len=length, last_only=True)).lower(
            jp, {k: _jstruct(*v) for k, v in shapes.items()}).compile()
        with FlopCounterMode(display=False) as fc:
            m.prefill(tp, {k: _tmeta(*v) for k, v in shapes.items()},
                      cache_len=length, last_only=True)
    else:
        jc = jax.eval_shape(lambda: jm.init_cache(b, length))
        hlo = jax.jit(jm.decode_step).lower(
            jp, jc, _jstruct((b, 1), "int32"),
            _jstruct((b,), "int32")).compile()
        with FlopCounterMode(display=False) as fc:
            m.decode_step(tp, _abstract_tree(m.cache_specs(b, length),
                                             m.cfg.dtype),
                          _tmeta((b, 1), "int32"), _tmeta((b,), "int32"))
    want = walk_costs(hlo.as_text())["flops"]
    got = fc.get_total_flops()
    assert abs(got - want) <= FLOP_TOL * want, (got, want)
