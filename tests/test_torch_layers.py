"""Port layers against the JAX reference: same numpy inputs through
``repro.models.layers`` and ``repro_torch.models.layers``.

Tolerance: both run float32 on the CPU; the functions repeat the
reference's arithmetic, so they agree to float32 rounding (1e-5 of the
values' scale; XLA and PyTorch may fuse and order sums differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as TL

TOL = 1e-5


def _close(j, t, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.detach().numpy().astype(np.float32)
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= tol * scale


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 256)])
def test_apply_norm(rng, shape):
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    p = {"scale": rng.standard_normal(shape[-1]).astype(np.float32)}
    _close(JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), "rmsnorm"),
           TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), "rmsnorm"))
    p["bias"] = rng.standard_normal(shape[-1]).astype(np.float32)
    _close(JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), "layernorm"),
           TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), "layernorm"))


NEW_TOL = 1e-6       # the layers this slice adds, float32 on the CPU


def _params(rng, specs):
    """numpy leaves for a spec tree: normals at the fan-in scale, int8 in
    [-64, 64] (as the reference draws them), scales near 1."""
    out = {}
    for k, s in specs.items():
        if s.dtype == "int8":
            out[k] = rng.integers(-64, 65, s.shape).astype(np.int8)
        elif k.endswith("_s"):
            out[k] = rng.uniform(0.5, 1.5, s.shape).astype(np.float32) / 64
        else:
            out[k] = (rng.standard_normal(s.shape) * s.scale
                      ).astype(np.float32)
    return out


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 256)])
@pytest.mark.parametrize("with_bias", [None, False, True])
def test_layernorm_matches_reference(rng, shape, with_bias):
    """LayerNorm with the population variance (``jnp.var``), its spec's
    bias by default and on request."""
    cfg = tget("nemotron-4-340b", smoke=True).with_(d_model=shape[-1])
    specs = TL.norm_specs(cfg, with_bias)
    assert specs.keys() == JL.norm_specs(cfg, with_bias).keys()
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    p = {k: rng.standard_normal(s.shape).astype(np.float32)
         for k, s in specs.items()}
    _close(JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), "layernorm"),
           TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), "layernorm"), NEW_TOL)


@pytest.mark.parametrize("activation", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("quant", [False, True])
def test_mlp_variants_match_reference(rng, activation, quant):
    """relu2, gelu (tanh approximation) and the int8 FFN (weights int8,
    per-channel float32 scales after each product) against the
    reference's ``apply_mlp``, specs included."""
    cfg = tget("nemotron-4-340b", smoke=True).with_(
        activation=activation, weight_quant="int8_ffn" if quant else "none")
    jcfg = get_config("nemotron-4-340b", smoke=True).with_(
        activation=activation, weight_quant="int8_ffn" if quant else "none")
    specs = TL.mlp_specs(cfg, d_ff=192)
    jspecs = JL.mlp_specs(jcfg, d_ff=192)
    assert {k: (s.shape, s.dtype, s.init) for k, s in specs.items()} == \
        {k: (s.shape, s.dtype, s.init) for k, s in jspecs.items()}
    p = _params(rng, specs)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    _close(JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), activation),
           TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), activation), NEW_TOL)


def test_quantize_ffn_params_matches_reference(rng):
    """Post-training int8 quantization: the same int8 weights and scales
    over a stacked tree (MLP dicts found at any depth, other leaves
    untouched)."""
    tree = {"layers": {"mlp": {
        "wi_gate": rng.standard_normal((2, 16, 24)).astype(np.float32),
        "wi_up": rng.standard_normal((2, 16, 24)).astype(np.float32),
        "wo": rng.standard_normal((2, 24, 16)).astype(np.float32)},
        "ln": {"scale": np.ones((2, 16), np.float32)}},
        "head": {"wi": rng.standard_normal((16, 8)).astype(np.float32),
                 "wo": rng.standard_normal((8, 16)).astype(np.float32)}}

    def conv(t, fn):
        return {k: conv(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}
    j = JL.quantize_ffn_params(conv(tree, jnp.asarray))
    t = TL.quantize_ffn_params(conv(tree, torch.from_numpy))

    jl = {p: np.asarray(x) for p, x in _leaves(j)}
    tl = {p: x.numpy() for p, x in _leaves(t)}
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, k
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-6, atol=0)


def _leaves(x, path=()):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, x


@pytest.mark.parametrize("theta", [1.0e4, 1.0e6])
def test_rope(rng, theta):
    pos = rng.integers(0, 2000, (2, 7)).astype(np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 64, theta)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 64, theta)
    _close(jc, tc)
    _close(js, ts)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    _close(JL.apply_rope(jnp.asarray(x), jc, js),
           TL.apply_rope(torch.from_numpy(x), tc, ts))


def test_mrope(rng):
    cfg = get_config("qwen2-vl-2b", smoke=True)
    pos = rng.integers(0, 500, (3, 2, 9)).astype(np.int32)
    jc, js = JL.mrope_cos_sin(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    tc, ts = TL.mrope_cos_sin(torch.from_numpy(pos), cfg.head_dim,
                              cfg.rope_theta, cfg.mrope_sections)
    _close(jc, tc)
    _close(js, ts)
    with pytest.raises(ValueError):
        TL.mrope_cos_sin(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta,
                         (8, 8, 8))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "phi4-mini-3.8b"])
def test_apply_mlp(rng, arch):
    cfg = tget(arch, smoke=True)
    specs = TL.mlp_specs(cfg)
    p = {k: (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
         for k, s in specs.items()}
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    _close(JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), "swiglu"),
           TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), "swiglu"))
    assert set(TL.mlp_specs(cfg.with_(activation="gelu"))) == {"wi", "wo"}
    with pytest.raises(ValueError):              # no such activation
        TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), "tanh")


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(rng, softcap, tied):
    cfg = get_config("phi4-mini-3.8b", smoke=True).with_(tie_embeddings=tied)
    specs = TL.embed_specs(cfg)
    p = {k: (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
         for k, s in specs.items()}
    toks = rng.integers(0, cfg.vocab_size, (2, 6))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(JL.embed_tokens(jp, jnp.asarray(toks)),
           TL.embed_tokens(tp, torch.from_numpy(toks)))
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    _close(JL.unembed(jp, jnp.asarray(x), softcap),
           TL.unembed(tp, torch.from_numpy(x), softcap))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "phi4-mini-3.8b"])
def test_param_specs_match_reference(arch):
    """Same tree, shapes and fan-in scales as the reference's specs."""
    from repro.models.registry import build as jbuild
    from repro_torch.models import build as tbuild

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, (tuple(tree.shape), tree.init, tree.scale)

    for smoke in (True, False):
        j = dict(leaves(jbuild(get_config(arch, smoke)).param_specs()))
        t = dict(leaves(tbuild(tget(arch, smoke)).param_specs()))
        assert j == t


def test_init_fan_in_scales():
    cfg = tget("qwen2-vl-2b", smoke=True)
    from repro_torch.models import build
    params = build(cfg).init(0, "cpu")
    wq = params["layers"]["attn"]["wq"]
    assert wq.dtype == torch.float32
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert torch.equal(params["layers"]["ln1"]["scale"],
                       torch.ones(cfg.num_layers, cfg.d_model))
    again = build(cfg).init(0, "cpu")
    assert torch.equal(again["embed"]["tok"], params["embed"]["tok"])
