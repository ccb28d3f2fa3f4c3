"""The port's architecture configs against the JAX reference's.

All ten archs' ``CONFIG`` / ``SMOKE_CONFIG`` carry the reference's field
values (``dataclasses.asdict``), the shapes and skips are the same, and
the parameter counts of the full configs the port builds equal the
reference's, from the spec trees alone (nothing is allocated)."""
import dataclasses

import pytest

from repro import configs as J
from repro_torch import configs as T


def test_arch_lists_match_reference():
    assert T.ARCHS == J.ARCHS
    assert T.SKIPS == J.SKIPS


@pytest.mark.parametrize("arch", J.ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_reference(arch, smoke):
    assert dataclasses.asdict(T.get_config(arch, smoke)) == \
        dataclasses.asdict(J.get_config(arch, smoke))


def test_shapes_match_reference():
    assert sorted(T.SHAPES) == sorted(J.SHAPES)
    for name, shape in J.SHAPES.items():
        assert dataclasses.asdict(T.SHAPES[name]) == dataclasses.asdict(shape)
        assert T.SHAPES[name].is_decode == shape.is_decode


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        T.get_config("llama-7b")


@pytest.mark.parametrize("arch", ["granite-34b", "mistral-large-123b",
                                  "nemotron-4-340b", "arctic-480b",
                                  "deepseek-v3-671b", "qwen2-vl-2b",
                                  "phi4-mini-3.8b", "rwkv6-3b",
                                  "zamba2-1.2b", "whisper-tiny"])
def test_param_counts_match_reference(arch):
    """Full widths and depths, counted from the spec trees. The
    reference discounts leaves whose path names ``expert``; its MoE leaves
    are ``moe/wi_gate`` and so on, so arctic's active count is its total
    there, and here."""
    t, j = T.get_config(arch), J.get_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    if t.family == "moe":
        variant = dict(first_k_dense_layers=1, num_shared_experts=1)
        assert t.with_(**variant).active_param_count() == \
            j.with_(**variant).active_param_count()


def test_perceiver_param_count_matches_reference():
    """qwen2-vl with the perceiver projector (64 latents, the default)."""
    t = T.get_config("qwen2-vl-2b").with_(projector="perceiver")
    j = J.get_config("qwen2-vl-2b").with_(projector="perceiver")
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch", J.ARCHS)
def test_derived_properties_match_reference(arch):
    t, j = T.get_config(arch), J.get_config(arch)
    assert t.is_attention_free == j.is_attention_free
    assert t.q_per_kv == j.q_per_kv
    assert t.kv_head_dim == j.kv_head_dim


@pytest.mark.parametrize("arch,kw", [
    ("rwkv6-3b", {}), ("zamba2-1.2b", {}), ("whisper-tiny", {}),
    ("qwen2-vl-2b", dict(projector="perceiver", num_latents=8))])
def test_params_from_flat_round_trip(arch, kw):
    """The reference's flattened ``a.b.c`` params of each new family come
    across whole: the port's spec tree has exactly those leaves, at their
    shapes, with the same values."""
    import jax
    import numpy as np
    from repro.models import build as j_build
    from repro.training.checkpoint import _flatten
    from repro_torch.models import build
    from repro_torch.models.convert import params_from_flat
    jm = j_build(J.get_config(arch, smoke=True).with_(**kw))
    flat = {k: np.asarray(v) for k, v in _flatten(
        jm.init(jax.random.PRNGKey(0))).items()}
    got = _flatten(params_from_flat(flat, "cpu"))
    specs = _flatten(build(T.get_config(arch, smoke=True).with_(
        **kw)).param_specs())
    assert got.keys() == flat.keys() == specs.keys()
    for k, v in flat.items():
        assert tuple(got[k].shape) == specs[k].shape == v.shape
        assert np.array_equal(got[k].numpy(), v)
