"""The port's perceiver resampler against the JAX reference's.

``apply_resampler`` on the same numpy weights and patches (float32, CPU)
for several patch counts, fewer than the latents included, within 1e-5
of the outputs' scale; the three
properties of ``tests/test_resampler.py`` on the port; a qwen2-vl smoke
``Model`` with ``projector="perceiver"`` (forward, prefill, decode_step)
within 1e-4 of the logit scale; and ``LVLM.generate`` with its greedy
tokens and virtual-clock TTFT / TPOT / JCT equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import GenerationConfig as JGen
from repro.configs import get_config
from repro.models.layers import init_params
from repro.models.resampler import apply_resampler as j_apply
from repro.models.resampler import resampler_specs as j_specs
from repro.training.checkpoint import _flatten
from repro_torch.api import LVLM, GenerationConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.convert import params_from_flat
from repro_torch.models.layers import init_params as t_init_params
from repro_torch.models.registry import build as t_build
from repro_torch.models.resampler import apply_resampler, resampler_specs

TOL = 1e-4
PERCEIVER = dict(projector="perceiver", num_latents=8)
_PAIR = {}


def _to_port(jparams):
    return params_from_flat({k: np.asarray(v)
                             for k, v in _flatten(jparams).items()}, "cpu")


def _pair():
    """(reference LVLM, port LVLM with its weights): qwen2-vl smoke with
    the perceiver projector, 8 latents."""
    if not _PAIR:
        j = JLVLM.from_pretrained("qwen2-vl-2b", smoke=True, **PERCEIVER)
        t = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, device="cpu",
                                 **PERCEIVER)
        _PAIR["p"] = (j, t.with_params(_to_port(j.params)))
    return _PAIR["p"]


def _close(j, t, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= tol * scale, np.abs(j - t).max() / scale


@pytest.mark.parametrize("n", [3, 8, 16, 57])
def test_apply_resampler_matches_reference(n):
    cfg = get_config("qwen2-vl-2b", smoke=True)
    jp = init_params(j_specs(cfg, num_latents=8), jax.random.PRNGKey(0),
                     "float32")
    patches = np.random.default_rng(n).standard_normal(
        (2, n, cfg.d_model)).astype(np.float32)
    want = j_apply(jp, jnp.asarray(patches))
    got = apply_resampler(_to_port(jp), torch.from_numpy(patches))
    assert got.shape == (2, 8, cfg.d_model)
    _close(want, got, 1e-5)          # 1e-5 of the outputs' scale


def test_resampler_fixed_output_any_input_length():
    cfg = t_get_config("qwen2-vl-2b", smoke=True)
    params = t_init_params(resampler_specs(cfg, num_latents=8), 0,
                           "float32", "cpu")
    for n in (4, 16, 57):
        patches = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (2, n, cfg.d_model)).astype(np.float32))
        out = apply_resampler(params, patches)
        assert out.shape == (2, 8, cfg.d_model)
        assert bool(torch.isfinite(out).all())


def test_vlm_with_perceiver_projector_end_to_end():
    cfg = t_get_config("qwen2-vl-2b", smoke=True).with_(**PERCEIVER)
    model = t_build(cfg)
    params = model.init(0, "cpu")
    rng = np.random.default_rng(1)
    b, s = 2, 12
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s))),
             "visual_embeds": torch.from_numpy(rng.standard_normal(
                 (b, cfg.num_visual_tokens, cfg.d_model)).astype(np.float32))}
    logits, _ = model.forward(params, batch)
    # sequence = num_latents (NOT num_visual_tokens) + text
    assert logits.shape == (b, 8 + s, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert 8 < cfg.num_visual_tokens


def test_resampler_attends_to_content():
    """Latent outputs change when the patches change (not a no-op)."""
    cfg = t_get_config("qwen2-vl-2b", smoke=True)
    params = t_init_params(resampler_specs(cfg, num_latents=4), 0,
                           "float32", "cpu")
    rng = np.random.default_rng(2)
    p1, p2 = (torch.from_numpy(rng.standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)) for _ in range(2))
    o1, o2 = apply_resampler(params, p1), apply_resampler(params, p2)
    assert float((o1 - o2).abs().max()) > 1e-3


def test_perceiver_model_entry_points_match_reference():
    j, t = _pair()
    cfg = j.model.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    ve = rng.standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "visual_embeds": jnp.asarray(ve)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "visual_embeds": torch.from_numpy(ve)}
    jf, _ = j.model.forward(j.params, jb)
    tf, _ = t.model.forward(t.params, tb)
    assert tf.shape[1] == 8 + 11
    _close(jf, tf)
    jl, jc = j.model.prefill(j.params, jb, cache_len=40)
    tl, tc = t.model.prefill(t.params, tb, cache_len=40)
    _close(jl, tl)
    _close(jc["layers"]["k"], tc["layers"]["k"])
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.array([19 + step, 19 + step], np.int32)
        jd, jc = j.model.decode_step(j.params, jc, jnp.asarray(nxt),
                                     jnp.asarray(pos))
        td, tc = t.model.decode_step(t.params, tc,
                                     torch.from_numpy(nxt).long(),
                                     torch.from_numpy(pos))
        _close(jd, td)


def test_perceiver_generate_matches_reference():
    """Greedy tokens and virtual-clock records through the facade; the
    engine counts the patches, not the latents, as visual tokens (the
    reference's rule, ROADMAP C5)."""
    j, t = _pair()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).tolist() for n in (13, 6, 20)]
    ves = [rng.standard_normal((n, 256)).astype(np.float32)
           for n in (16, 5, 30)]
    jr = j.generate(prompts, JGen(max_new_tokens=6, decoder="greedy"),
                    visual_embeds=ves)
    tr = t.generate(prompts, GenerationConfig(max_new_tokens=6,
                                              decoder="greedy"),
                    visual_embeds=ves)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [(r.request.ttft(), r.request.tpot(), r.request.jct())
            for r in tr] == [(r.request.ttft(), r.request.tpot(),
                              r.request.jct()) for r in jr]
