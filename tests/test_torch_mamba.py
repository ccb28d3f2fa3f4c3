"""The port's Mamba-2 and the ``hybrid`` family (zamba2-1.2b smoke)
against the JAX reference's, on the CPU in float32 with the same numpy
weights.

* ``mamba_forward`` at T = 12, 16 and 256 (chunks 4, 16 and 128, the
  hybrid family's rule), with and without an incoming state, its final
  conv and SSD states included, and ``mamba_decode_step``, within 1e-5 of
  their scale; the chunked forward against a step-by-step decode over the
  same tokens (within 1e-4).
* The hybrid ``Model``'s forward, prefill and decode logits within 1e-4
  of the logit scale, with a prompt longer than the shared block's
  window of 64, so that its KV ring wraps.
* ``LVLM.generate`` tokens and virtual-clock records equal to the
  reference's with such a prompt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import GenerationConfig as JGen
from repro.models import mamba as JM
from repro.models.layers import init_params
from repro.training.checkpoint import _flatten
from repro_torch.api import LVLM, GenerationConfig
from repro_torch.configs import get_config
from repro_torch.models import mamba as M
from repro_torch.models.convert import params_from_flat
from repro_torch.models.transformer import Model

TOL = 1e-4
STATE_TOL = 1e-5
CFG = get_config("zamba2-1.2b", smoke=True)
_PAIR = {}


def _to_port(tree):
    return params_from_flat({k: np.asarray(v)
                             for k, v in _flatten(tree).items()}, "cpu")


def _pair():
    if not _PAIR:
        j = JLVLM.from_pretrained("zamba2-1.2b", smoke=True)
        t = LVLM.from_pretrained("zamba2-1.2b", smoke=True, device="cpu")
        _PAIR["p"] = (j, t.with_params(_to_port(j.params)))
    return _PAIR["p"]


def _close(j, t, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= tol * scale, np.abs(j - t).max() / scale


def _mamba_params():
    """One Mamba-2 layer's weights, with a non-zero dt bias and conv bias
    (the init leaves them 0) and a_log spread over heads."""
    jp = init_params(JM.mamba_specs(CFG), jax.random.PRNGKey(0), "float32")
    rng = np.random.default_rng(10)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-2, 0, jp["dt_bias"].shape
                                            ).astype(np.float32))
    jp["a_log"] = jnp.asarray(rng.uniform(-1, 1.5, jp["a_log"].shape
                                          ).astype(np.float32))
    jp["conv_b"] = jnp.asarray(0.1 * rng.standard_normal(
        jp["conv_b"].shape).astype(np.float32))
    return jp


def _state(rng, b):
    d_inner = CFG.ssm_expand * CFG.d_model
    nh, n = d_inner // CFG.ssm_head_dim, CFG.ssm_state_dim
    return {"conv": rng.standard_normal(
        (b, CFG.ssm_conv_dim - 1, d_inner + 2 * n)).astype(np.float32),
        "ssd": 0.5 * rng.standard_normal((b, nh, CFG.ssm_head_dim, n)
                                         ).astype(np.float32)}


@pytest.mark.parametrize("t", [12, 16, 256])
@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_forward_matches_reference(t, with_cache):
    jp = _mamba_params()
    tp = _to_port(jp)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, CFG.d_model)).astype(np.float32)
    chunk = Model._chunk(x)
    assert chunk == {12: 4, 16: 16, 256: 128}[t]
    st = _state(rng, 2) if with_cache else None
    jo, js = JM.mamba_forward(jp, jnp.asarray(x), CFG, chunk=chunk,
                              cache=None if st is None else
                              {k: jnp.asarray(v) for k, v in st.items()})
    to, ts = M.mamba_forward(tp, torch.from_numpy(x), CFG, chunk=chunk,
                             cache=None if st is None else
                             {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jo, to, STATE_TOL)
    assert js.keys() == ts.keys()
    for k in js:
        _close(js[k], ts[k], STATE_TOL)


def test_mamba_decode_step_matches_reference():
    jp = _mamba_params()
    tp = _to_port(jp)
    rng = np.random.default_rng(11)
    st = _state(rng, 3)
    x = rng.standard_normal((3, 1, CFG.d_model)).astype(np.float32)
    for _ in range(3):
        jo, js = JM.mamba_decode_step(jp, jnp.asarray(x), CFG,
                                      {k: jnp.asarray(v)
                                       for k, v in st.items()})
        to, ts = M.mamba_decode_step(tp, torch.from_numpy(x), CFG,
                                     {k: torch.from_numpy(v)
                                      for k, v in st.items()})
        _close(jo, to, STATE_TOL)
        for k in js:
            _close(js[k], ts[k], STATE_TOL)
        st = {k: np.array(v) for k, v in js.items()}
        x = np.array(jo)


@pytest.mark.parametrize("t", [12, 32])
def test_chunked_forward_equals_stepwise_decode(t):
    """The chunked SSD over T tokens gives, token for token, the O(1)
    recurrence's outputs, and the same final state."""
    tp = _to_port(_mamba_params())
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, t, CFG.d_model)).astype(np.float32))
    zeros = {k: torch.zeros_like(torch.from_numpy(v))
             for k, v in _state(np.random.default_rng(0), 2).items()}
    full, fin = M.mamba_forward(tp, x, CFG, chunk=Model._chunk(x),
                                cache=dict(zeros))
    st, outs = dict(zeros), []
    for i in range(t):
        y, st = M.mamba_decode_step(tp, x[:, i:i + 1], CFG, st)
        outs.append(y)
    step = torch.cat(outs, 1)
    scale = float(full.abs().max())
    assert float((full - step).abs().max()) <= 1e-4 * scale
    assert float((fin["ssd"] - st["ssd"]).abs().max()) <= \
        1e-4 * float(st["ssd"].abs().max())
    # the conv window holds in_proj outputs: a [B,1] and a [B,T] product
    # round alike only to float32 precision
    assert float((fin["conv"] - st["conv"]).abs().max()) <= \
        1e-5 * float(st["conv"].abs().max())


def test_hybrid_model_entry_points_match_reference():
    j, t = _pair()
    rng = np.random.default_rng(13)
    s = 80                                  # past the window of 64: wraps
    toks = rng.integers(0, CFG.vocab_size, (2, s)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    jf, _ = j.model.forward(j.params, {"tokens": jt})
    tf, _ = t.model.forward(t.params, {"tokens": tt})
    _close(jf, tf)
    jl, jc = j.model.prefill(j.params, {"tokens": jt}, cache_len=96)
    tl, tc = t.model.prefill(t.params, {"tokens": tt}, cache_len=96)
    _close(jl, tl)
    assert tc["shared_attn"]["k"].shape[2] == CFG.sliding_window
    for k in ("k", "v", "slot_pos"):
        _close(jc["shared_attn"][k], tc["shared_attn"][k])
    for k in ("conv", "ssd"):
        _close(jc["layers"][k], tc["layers"][k], STATE_TOL)
    for step in range(3):
        nxt = rng.integers(0, CFG.vocab_size, (2, 1)).astype(np.int32)
        pos = np.array([s + step, s + step], np.int32)
        jd, jc = j.model.decode_step(j.params, jc, jnp.asarray(nxt),
                                     jnp.asarray(pos))
        td, tc = t.model.decode_step(t.params, tc,
                                     torch.from_numpy(nxt).long(),
                                     torch.from_numpy(pos))
        _close(jd, td)
    _close(jc["shared_attn"]["slot_pos"], tc["shared_attn"]["slot_pos"])


def test_zamba2_generate_matches_reference():
    """A 75-token prompt: the shared block's ring of 64 wraps in prefill
    and again while decoding."""
    j, t = _pair()
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n in (75, 9)]
    jr = j.generate(prompts, JGen(max_new_tokens=6, decoder="greedy"))
    tr = t.generate(prompts, GenerationConfig(max_new_tokens=6,
                                              decoder="greedy"))
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [(r.request.ttft(), r.request.tpot(), r.request.jct())
            for r in tr] == [(r.request.ttft(), r.request.tpot(),
                              r.request.jct()) for r in jr]
