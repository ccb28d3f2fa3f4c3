"""The port's decoding library (speculative decoding, LANTERN, early exit)
and the paged kernel's multi-query plain version against the JAX
reference (float32 smoke configs, CPU).

Same weights through the bridge, same numpy inputs. At temperature 0 the
speculative round is deterministic in both packages (acceptance at
u = 0.5 on one-hot distributions), so tokens and every ``SpecStats``
field must be identical, LANTERN included; logits and caches agree within
1e-4 of their scale, the port's model tolerance; ``layer_confidences``
within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.core.decoding import early_exit as jee
from repro.core.decoding import speculative as jspec
from repro.models.attention import simple_sdpa as jsimple_sdpa
from repro.models.registry import build as jbuild
from repro.training.checkpoint import _flatten
from repro_torch.api import LVLM
from repro_torch.core.decoding import early_exit as tee
from repro_torch.core.decoding import speculative as tspec
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.convert import params_from_flat
from repro_torch.models.registry import build as tbuild

TOL = 1e-4
GAMMA = 3


def _bridge(j):
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    return params_from_flat(flat, "cpu")


def _pair(arch, **over):
    j = JLVLM.from_pretrained(arch, smoke=True, **over)
    t = LVLM.from_pretrained(arch, smoke=True, device="cpu", **over)
    return j, t.with_params(_bridge(j))


@pytest.fixture(scope="module")
def phi():
    return _pair("phi4-mini-3.8b")


@pytest.fixture(scope="module")
def draft():
    """The reference tests' small draft: 1 layer, d_model 128, same vocab."""
    from repro.configs import get_config
    cfg = get_config("phi4-mini-3.8b", smoke=True).with_(
        num_layers=1, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        head_dim=32)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(1))
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    tm = tbuild(LVLM.from_pretrained("phi4-mini-3.8b", smoke=True,
                                     device="cpu").cfg.with_(
        num_layers=1, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        head_dim=32))
    return (jm, jp), (tm, params_from_flat(flat, "cpu"))


@pytest.fixture(scope="module")
def vlm():
    return _pair("qwen2-vl-2b")


def _close(j, t):
    j, t = np.asarray(j), t.detach().numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= TOL * scale, np.abs(j - t).max() / scale


def _stats(st):
    return (st.proposed, st.accepted, st.bonus, st.target_calls,
            st.draft_calls, st.tokens_emitted, st.rejected_resamples,
            st.mean_accepted_per_call())


# ------------------------------------------------------------ acceptance --

def _block(rng, vocab, gamma, agree):
    """Target logits [1, gamma+1, V] and one-hot draft distributions whose
    tokens equal the target's argmax for the first ``agree`` positions."""
    logits = rng.standard_normal((1, gamma + 1, vocab)).astype(np.float32)
    am = logits[0].argmax(-1)
    toks = [int(am[g]) if g < agree else int((am[g] + 1 + g) % vocab)
            for g in range(gamma)]
    ps = np.zeros((gamma, vocab), np.float32)
    ps[np.arange(gamma), toks] = 1.0
    return logits, toks, ps


@pytest.mark.parametrize("agree", [0, 1, 2, 3])
@pytest.mark.parametrize("lantern", [None, 0.2, 0.6])
def test_accept_block_matches_reference(phi, agree, lantern):
    """Temperature 0, with and without LANTERN (a delta above 0.5 accepts
    a neighbour of the target's argmax at u = 0.5): the same emitted
    tokens, accepted count and bonus; ``limit`` cuts a full block."""
    j, t = phi
    vocab = t.cfg.vocab_size
    rng = np.random.default_rng(agree)
    logits, toks, ps = _block(rng, vocab, GAMMA, agree)
    nb = None
    if lantern is not None:
        nb = jspec.lantern_neighbourhood_from_params(j.params, 8)
        # make the rejected draft a neighbour of the target's argmax
        if agree < GAMMA:
            am = int(logits[0, agree].argmax())
            toks[agree] = int(nb[am][1])
            ps[agree] = 0.0
            ps[agree, toks[agree]] = 1.0
            nb = nb.copy()
            nb[toks[agree], 1] = am
    for limit in (GAMMA + 1, 2):
        want = jspec.accept_block(
            jax.random.PRNGKey(0), jnp.asarray(logits), toks,
            [jnp.asarray(p) for p in ps], temperature=0.0, limit=limit,
            nbhd=nb, lantern_delta=lantern or 0.2)
        got = tspec.accept_block(
            None, torch.from_numpy(logits), toks,
            [torch.from_numpy(p) for p in ps], temperature=0.0, limit=limit,
            nbhd=nb, lantern_delta=lantern or 0.2)
        assert got[:3] == want[:3], (limit, got[:3], want[:3])
        if lantern == 0.6 and agree < min(GAMMA, limit):
            assert got[1] == agree + 1        # the neighbour was accepted


def test_lantern_table_matches_reference(phi):
    j, t = phi
    for k in (2, 5):
        assert np.array_equal(
            tspec.lantern_neighbourhood_from_params(t.params, k),
            jspec.lantern_neighbourhood_from_params(j.params, k))


def test_param_counts_match_reference(phi, vlm, draft):
    """The draft's virtual-clock cost ratio reads these counts."""
    for (j, t) in (phi, vlm):
        assert t.cfg.active_param_count() == j.cfg.active_param_count()
    (jm, _), (tm, _) = draft
    assert tm.cfg.param_count() == jm.cfg.param_count()


# -------------------------------------------------- speculative_generate --

def _prompt(cfg, n, seed):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size,
                                               size=n).tolist()


@pytest.mark.parametrize("kind", ["small_draft", "self_draft"])
def test_speculative_generate_matches_reference(phi, draft, kind):
    j, t = phi
    (jm, jp), (tm, tp) = draft
    if kind == "self_draft":
        jm, jp, tm, tp = j.model, j.params, t.model, t.params
    prompt = _prompt(t.cfg, 20, 0)
    want, wst = jspec.speculative_generate(
        j.model, jm, j.params, jp, prompt, max_new_tokens=10, gamma=GAMMA,
        temperature=0.0)
    got, gst = tspec.speculative_generate(
        t.model, tm, t.params, tp, prompt, max_new_tokens=10, gamma=GAMMA,
        temperature=0.0)
    assert got == want
    assert _stats(gst) == _stats(wst)


def test_self_draft_acceptance_is_exactly_one(phi):
    """Self-draft on a text-only prompt whose rounds tile evenly
    (max_new = 1 + k * (gamma + 1)) accepts every proposal."""
    j, t = phi
    prompt = _prompt(t.cfg, 12, 1)
    toks, st = tspec.speculative_generate(
        t.model, t.model, t.params, t.params, prompt,
        max_new_tokens=1 + 2 * (GAMMA + 1), gamma=GAMMA, temperature=0.0)
    assert tspec.acceptance_rate(st) == 1.0
    want, wst = jspec.speculative_generate(
        j.model, j.model, j.params, j.params, prompt,
        max_new_tokens=1 + 2 * (GAMMA + 1), gamma=GAMMA, temperature=0.0)
    assert toks == want and _stats(st) == _stats(wst)


def test_lantern_generate_matches_reference(phi, draft):
    """LANTERN at temperature 0 with delta > 0.5: a draft token whose
    neighbourhood holds the target's argmax is accepted, so the stream
    leaves the greedy one (a 256-token neighbourhood of the 512-token
    vocab, so the random draft lands in it); both packages leave it
    identically."""
    j, t = phi
    (jm, jp), (tm, tp) = draft
    prompt = _prompt(t.cfg, 16, 2)
    kw = dict(max_new_tokens=12, gamma=GAMMA, temperature=0.0,
              lantern_k=256, lantern_delta=0.6)
    want, wst = jspec.speculative_generate(j.model, jm, j.params, jp, prompt,
                                           **kw)
    got, gst = tspec.speculative_generate(t.model, tm, t.params, tp, prompt,
                                          **kw)
    assert got == want
    assert _stats(gst) == _stats(wst)
    plain, pst = tspec.speculative_generate(
        t.model, tm, t.params, tp, prompt, max_new_tokens=12, gamma=GAMMA,
        temperature=0.0)
    assert gst.accepted > pst.accepted and got != plain


def test_speculative_generate_vlm_matches_reference(vlm):
    """The target verifies with the visual embeddings, the self-draft runs
    text-only (low acceptance by design): tokens and stats equal."""
    j, t = vlm
    cfg = t.cfg
    prompt = _prompt(cfg, 10, 3)
    ve = np.random.default_rng(3).standard_normal(
        (cfg.num_visual_tokens, cfg.d_model)).astype(np.float32) * 0.02
    want, wst = jspec.speculative_generate(
        j.model, j.model, j.params, j.params, prompt, max_new_tokens=9,
        gamma=GAMMA, temperature=0.0, visual_embeds=jnp.asarray(ve))
    got, gst = tspec.speculative_generate(
        t.model, t.model, t.params, t.params, prompt, max_new_tokens=9,
        gamma=GAMMA, temperature=0.0, visual_embeds=ve)
    assert got == want
    assert _stats(gst) == _stats(wst)


# -------------------------------------------------------------- early exit --

def _decode_state(j, t, seed, b=2):
    cfg = t.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, 14)).astype(np.int32)
    _, jc = j.model.prefill(j.params, {"tokens": jnp.asarray(toks)},
                            cache_len=32)
    _, tc = t.model.prefill(t.params, {"tokens": torch.from_numpy(toks)
                                       .long()}, cache_len=32)
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    return jc, tc, nxt


def test_layer_confidences_match_reference(phi):
    j, t = phi
    jc, tc, nxt = _decode_state(j, t, 4)
    want = jee.layer_confidences(j.model, j.params, jc, jnp.asarray(nxt), 14)
    got = tee.layer_confidences(t.model, t.params, tc,
                                torch.from_numpy(nxt).long(), 14)
    assert got.shape == tuple(want.shape)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5


@pytest.mark.parametrize("arch", ["phi", "vlm"])
@pytest.mark.parametrize("threshold,patience,min_layers", [
    (1.1, 2, 2), (0.0, 0, 1)])
def test_early_exit_step_matches_reference(phi, vlm, arch, threshold,
                                           patience, min_layers):
    """Never firing (1.1) and firing at layer 1 (0.0): logits, depth, the
    exit flag and the cache, whose skipped layers are back-filled with the
    exit hidden state, match the reference."""
    j, t = phi if arch == "phi" else vlm
    jc, tc, nxt = _decode_state(j, t, 5, b=1)
    kw = dict(threshold=threshold, patience=patience, min_layers=min_layers)
    jl, jc, jinfo = jee.early_exit_decode_step(
        j.model, j.params, jc, jnp.asarray(nxt), 14, **kw)
    k_before = tc["layers"]["k"].clone()
    tl, tc2, tinfo = tee.early_exit_decode_step(
        t.model, t.params, tc, torch.from_numpy(nxt).long(), 14, **kw)
    assert tc2 is tc                        # updated in place
    assert tinfo == jinfo
    assert tinfo["exited"] == (threshold == 0.0)
    _close(jl, tl)
    for name in ("k", "v"):
        _close(jc["layers"][name], tc["layers"][name])
    # every layer wrote position 14, the skipped ones by the back-fill
    assert bool((tc["layers"]["k"][:, :, 14] != k_before[:, :, 14])
                .any(-1).any(-1).all())


def test_early_exit_writes_through_a_slot_view(phi):
    """The engine hands early exit a batch-1 view of its slot pool: the
    back-filled layers land in the pool, not in a copy."""
    from repro_torch.core.serving.engine import _slot_get
    _, t = phi
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, t.cfg.vocab_size, (3, 10)))
    _, pool = t.model.prefill(t.params, {"tokens": toks}, cache_len=24)
    before = pool["layers"]["k"].clone()
    tee.early_exit_decode_step(t.model, t.params, _slot_get(pool, 1),
                               toks[1:2, -1:], 10, threshold=0.0,
                               patience=0, min_layers=1)
    changed = (pool["layers"]["k"] != before).any(-1).any(-1)  # [L, B, S]
    assert bool(changed[:, 1, 10].all())            # every layer, slot 1
    assert not bool(changed[:, [0, 2]].any())       # no other slot


# ---------------------------------------------------- multi-query plain --

@pytest.mark.parametrize("s_new", [1, 2, 5, 8])
def test_multi_query_plain_matches_simple_sdpa(s_new):
    """The paged kernel's multi-query plain version (and its split-KV
    algorithm) on per-row [B] starts against the reference's simple_sdpa
    over the slot cache, inactive rows routed to the scratch slot
    (start = L - 1, their queries past the cache) included."""
    rng = np.random.default_rng(7 + s_new)
    b, h, kvh, d, length, page = 5, 12, 2, 64, 96, 16
    starts = np.array([0, 31 - s_new // 2, 60, length - 2 - s_new,
                       length - 1])
    q = rng.standard_normal((b, s_new, h, d)).astype(np.float32)
    k = rng.standard_normal((b, length, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, length, kvh, d)).astype(np.float32)
    q_pos = (starts[:, None] + np.arange(s_new)).astype(np.int32)
    want = np.asarray(jsimple_sdpa(
        jnp.asarray(q).reshape(b, s_new, kvh, h // kvh, d), jnp.asarray(k),
        jnp.asarray(v), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.arange(length, dtype=jnp.int32), causal=True))
    table = torch.arange(b * length // page, dtype=torch.int32).view(b, -1)
    seq = torch.from_numpy(np.minimum(starts + s_new, length).astype(np.int32))
    args = (torch.from_numpy(q), torch.from_numpy(k).view(-1, page, kvh, d),
            torch.from_numpy(v).view(-1, page, kvh, d), table, seq)
    qp = torch.from_numpy(q_pos)
    got = pa.paged_attention(*args, q_pos=qp)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    for split in (32, 7):
        split_got = pa.paged_attention_split_plain(*args, split, q_pos=qp)
        assert np.abs(split_got.numpy() - want).max() <= 1e-5
    # a permuted table reads the same logical rows
    perm = torch.from_numpy(rng.permutation(table.numel()).astype(np.int32)
                            ).view(table.shape)
    pages = []
    for x in args[1:3]:
        y = torch.empty_like(x)
        y[perm.flatten().long()] = x
        pages.append(y)
    got_p = pa.paged_attention(args[0], *pages, perm, seq, q_pos=qp)
    assert np.abs(got_p.numpy() - want).max() <= 1e-5


def test_multi_query_refusals_on_every_device():
    q = torch.zeros(2, 3, 4, 64)
    pages = torch.zeros(4, 16, 2, 64)
    table = torch.arange(4, dtype=torch.int32).view(2, 2)
    seq = torch.ones(2, dtype=torch.int32)
    q_pos = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):                 # [B] positions
        pa.paged_attention(q, pages, pages, table, seq, q_pos=q_pos[:, 0])
    with pytest.raises(ValueError):                 # with k_pos
        pa.paged_attention(q, pages, pages, table, seq, q_pos=q_pos,
                           k_pos=torch.zeros(4, 16, dtype=torch.int32))
    with pytest.raises(ValueError):                 # with a window
        pa.paged_attention(q, pages, pages, table, seq, q_pos=q_pos,
                           window=4)
