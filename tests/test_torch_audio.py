"""The port's ``audio`` family (whisper-tiny smoke) against the JAX
reference's, on the CPU in float32 with the same numpy weights and
frames.

* ``forward``, ``prefill(batch["frames"])`` (its self-attention and
  cross caches included) and ``decode_step`` logits within 1e-4 of the
  logit scale; the decode after an S-1 prefill against the forward at
  S-1 (``tests/test_arch_smoke.py``'s invariant), in the port.
* The facade cannot drive whisper, as in the reference:
  ``LVLM.generate`` raises ``KeyError: 'frames'`` in both (ROADMAP C5),
  and ``extend`` raises ``NotImplementedError``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import GenerationConfig as JGen
from repro.training.checkpoint import _flatten
from repro_torch.api import LVLM, GenerationConfig
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_flat

TOL = 1e-4
CFG = get_config("whisper-tiny", smoke=True)
_PAIR = {}


def _pair():
    if not _PAIR:
        j = JLVLM.from_pretrained("whisper-tiny", smoke=True)
        t = LVLM.from_pretrained("whisper-tiny", smoke=True, device="cpu")
        flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
        _PAIR["p"] = (j, t.with_params(params_from_flat(flat, "cpu")))
    return _PAIR["p"]


def _close(j, t, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= tol * scale, np.abs(j - t).max() / scale


def _batch(rng, b, s):
    toks = rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
    frames = (0.5 * rng.standard_normal((b, CFG.encoder_seq, CFG.d_model))
              ).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks).long(),
             "frames": torch.from_numpy(frames)})


def test_whisper_entry_points_match_reference():
    j, t = _pair()
    rng = np.random.default_rng(15)
    jb, tb = _batch(rng, 2, 10)
    jf, _ = j.model.forward(j.params, jb)
    tf, _ = t.model.forward(t.params, tb)
    _close(jf, tf)
    jl, jc = j.model.prefill(j.params, jb, cache_len=24)
    tl, tc = t.model.prefill(t.params, tb, cache_len=24)
    _close(jl, tl)
    for key in ("layers", "cross"):
        for k in ("k", "v"):
            _close(jc[key][k], tc[key][k])
    for step in range(3):
        nxt = rng.integers(0, CFG.vocab_size, (2, 1)).astype(np.int32)
        pos = np.array([10 + step, 10 + step], np.int32)
        jd, jc = j.model.decode_step(j.params, jc, jnp.asarray(nxt),
                                     jnp.asarray(pos))
        td, tc = t.model.decode_step(t.params, tc,
                                     torch.from_numpy(nxt).long(),
                                     torch.from_numpy(pos))
        _close(jd, td)


@pytest.mark.parametrize("s", [6, 12])
def test_whisper_decode_after_prefill_equals_forward(s):
    """decode_step after an S-1 prefill gives the forward's logits at
    position S-1 (the reference's cache-correctness invariant)."""
    _, t = _pair()
    _, tb = _batch(np.random.default_rng(16 + s), 2, s)
    full, _ = t.model.forward(t.params, tb)
    pre = dict(tb, tokens=tb["tokens"][:, :-1])
    _, cache = t.model.prefill(t.params, pre, cache_len=s + 4)
    step, _ = t.model.decode_step(t.params, cache, tb["tokens"][:, -1:],
                                  s - 1)
    scale = float(full[:, -1].abs().max())
    assert float((step - full[:, -1]).abs().max()) <= TOL * scale


def test_facade_and_extend_refusals_match_reference():
    j, t = _pair()
    prompts = [[3, 4, 5, 6]]
    with pytest.raises(KeyError, match="frames"):
        j.generate(prompts, JGen(max_new_tokens=2, decoder="greedy"))
    with pytest.raises(KeyError, match="frames"):
        t.generate(prompts, GenerationConfig(max_new_tokens=2,
                                             decoder="greedy"))
    with pytest.raises(NotImplementedError, match="audio"):
        j.model.extend(j.params, j.model.init_cache(1, 16),
                       jnp.asarray([[1, 2]]), 3)
    with pytest.raises(NotImplementedError, match="audio"):
        t.model.extend(t.params, t.model.init_cache(1, 16),
                       torch.tensor([[1, 2]]), 3)
