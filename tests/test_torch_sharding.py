"""The port's sharding rules against the reference's, spec for spec, on
the production meshes (abstract: no device, no process group).

For all ten archs on ``(16, 16)`` and ``(2, 16, 16)``: every param's
partition spec (fsdp on and off), every decode / long-context cache
leaf's, the batch specs and the logits sharding equal the reference's
``PartitionSpec`` entries. Then the reference's own checks
(``tests/test_sharding_roofline.py``) on the port's rules: divisibility,
experts over "model", 2D sharding of the big archs, the pod axis on the
batch only. And the MoE layer's token groups (``_mesh_groups``) under a
mesh equal the reference's.
"""
import jax
import pytest

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.launch.steps import effective_config as jeffective
from repro.models import moe as jmoe
from repro.models.layers import tree_map_specs as jmap
from repro.models.registry import build as jbuild
from repro.sharding import abstract_mesh as jabstract
from repro.sharding.specs import ShardingRules as JRules
from repro.sharding.specs import logits_sharding as jlogits
from repro_torch.configs import get_config
from repro_torch.launch.steps import effective_config
from repro_torch.models import build
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import tree_map_specs
from repro_torch.sharding import (ShardingRules, abstract_mesh,
                                  logits_sharding, placements, use_mesh)

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}


def _rules(mesh_id, fsdp=True):
    sizes, names = MESHES[mesh_id]
    return (JRules(jabstract(sizes, names), fsdp=fsdp),
            ShardingRules(abstract_mesh(sizes, names), fsdp=fsdp))


def _leaves(mapper, tree):
    out = {}
    mapper(lambda path, s: out.__setitem__("/".join(path), s), tree)
    return out


def _same(jtree, ttree, jfn, tfn):
    js, ts = _leaves(jmap, jtree), _leaves(tree_map_specs, ttree)
    assert js.keys() == ts.keys()
    for k in js:
        assert tuple(js[k].shape) == tuple(ts[k].shape), k
        assert tuple(jfn(js[k])) == tfn(ts[k]), k


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pspecs_equal_reference(arch, mesh_id):
    for fsdp in (True, False):
        jr, tr = _rules(mesh_id, fsdp)
        _same(jbuild(jget(arch)).param_specs(),
              build(get_config(arch)).param_specs(),
              jr.param_pspec, tr.param_pspec)
    jr, tr = _rules(mesh_id)
    for shape in ("decode_32k", "long_500k", "prefill_32k"):
        jcfg, tcfg = jeffective(arch, shape), effective_config(arch, shape)
        batch = {"decode_32k": 128, "long_500k": 1, "prefill_32k": 32}[shape]
        length = min(32768, jcfg.decoder_max_seq or 32768)
        windowed = shape == "long_500k" and jcfg.family in ("dense", "vlm",
                                                             "moe")
        _same(jbuild(jcfg).cache_specs(batch, length, windowed=windowed),
              build(tcfg).cache_specs(batch, length, windowed=windowed),
              jr.cache_pspec, tr.cache_pspec)
    for ndim, b in ((2, 256), (1, 128), (2, 1), (3, 16), (2, 48)):
        assert tuple(jr.batch_pspec(ndim, batch_size=b)) \
            == tr.batch_pspec(ndim, batch_size=b)
    v = get_config(arch).vocab_size
    for shape in ((128, v), (32, 1, v), (1, v)):
        assert tuple(jlogits(jr, shape).spec) \
            == logits_sharding(tr, shape).spec


def _bad(spec_tree, rules, fn):
    bad = []

    def one(path, s):
        for i, entry in enumerate(fn(s)):
            parts = 1
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                parts *= rules.shape[a]
            if s.shape[i] % parts:
                bad.append("/".join(path))
    tree_map_specs(one, spec_tree)
    return bad


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_divide(arch, mesh_id):
    _, rules = _rules(mesh_id)
    model = build(get_config(arch))
    assert not _bad(model.param_specs(), rules, rules.param_pspec)
    cache_len = min(32768, get_config(arch).decoder_max_seq or 32768)
    assert not _bad(model.cache_specs(128, cache_len), rules,
                    rules.cache_pspec)


@pytest.mark.parametrize("check", ["big_archs_2d", "experts_over_model",
                                   "pod_batch_only"])
def test_reference_checks_hold(check):
    _, rules = _rules("1pod")
    if check == "big_archs_2d":
        for arch in ("mistral-large-123b", "nemotron-4-340b",
                     "deepseek-v3-671b"):
            n_2d = []
            tree_map_specs(lambda p, s: n_2d.append(
                {"data", "model"} <= set(rules.param_pspec(s))),
                build(get_config(arch)).param_specs())
            assert any(n_2d), arch
    elif check == "experts_over_model":
        moe = build(get_config("deepseek-v3-671b")).param_specs()[
            "layers"]["moe"]
        for name in ("wi_gate", "wo"):
            assert rules.param_pspec(moe[name])[1] == "model"
    else:
        _, rules = _rules("2pod")

        def one(path, s):
            flat = [a for e in rules.param_pspec(s)
                    for a in ((e,) if isinstance(e, str) else e or ())]
            assert "pod" not in flat, path
        tree_map_specs(one, build(get_config("granite-34b")).param_specs())
        assert rules.batch_pspec(2, batch_size=256)[0] == ("pod", "data")


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((), mesh) == (Replicate(),) * 3


@pytest.mark.parametrize("mesh_id", [None, "1pod", "2pod"])
def test_mesh_groups_equal_reference(mesh_id):
    for t in (4096, 100, 8, 1 << 20):
        if mesh_id is None:
            assert tmoe._mesh_groups(t) == jmoe._mesh_groups(t)
            continue
        sizes, names = MESHES[mesh_id]
        with jax.sharding.use_abstract_mesh(jabstract(sizes, names)):
            want = jmoe._mesh_groups(t)
        with use_mesh(abstract_mesh(sizes, names)):
            got = tmoe._mesh_groups(t)
        assert got == want, (t, got, want)
