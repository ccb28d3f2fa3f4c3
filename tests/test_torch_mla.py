"""The port's MLA (DeepSeek-V3 multi-head latent attention) against the
JAX reference, deepseek-v3 smoke on the CPU in float32.

The reference's params reach the port through the flattened bridge; the
same numpy inputs go through both packages.

* ``mla_attention_ref`` (the latent kernel's plain version) against the
  reference's absorbed-decode einsums, and ``mla_full_attention`` /
  ``mla_append_attention`` (scalar start, [B] starts, windowed, a wrapped
  ring) / ``mla_decode_attention`` (plain and windowed cache) against the
  reference's functions: outputs and caches within 1e-5 of their scale.
  The port computes [B]-start extends and wrapped-ring extends in the
  absorbed form where the reference uses the naive one (ROADMAP C3): the
  two agree to float32 rounding.
* ``Model`` forward / prefill / extend (scalar and [B] starts) /
  decode_step logits within 1e-4 of the logit scale, windowed too.
* The MLA leaves cross the bridge with their shapes (the full config's
  from its spec tree, nothing allocated); a reference npz checkpoint of
  deepseek smoke loads; compaction and early exit refuse MLA with the
  reference's errors, and early exit's back-fill of skipped layers writes
  the latent cache as the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.configs import ARCHS, get_config
from repro.core.decoding import early_exit as jee
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models.registry import build as jbuild
from repro.training.checkpoint import _flatten, save_checkpoint
from repro_torch.api import LVLM
from repro_torch.configs import get_config as tget
from repro_torch.core.decoding import early_exit as tee
from repro_torch.kernels import mla_attention as ma
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tL
from repro_torch.models.convert import load_checkpoint, params_from_flat

ARCH = "deepseek-v3-671b"
FN_TOL = 1e-5          # attention functions, float32
LOGIT_TOL = 1e-4       # model entry points, of the logit scale


@pytest.fixture(scope="module")
def pair():
    """(reference LVLM, port LVLM) with the same deepseek-v3 smoke
    weights."""
    j = JLVLM.from_pretrained(ARCH, smoke=True)
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    t = LVLM.from_pretrained(ARCH, smoke=True, device="cpu")
    return j, t.with_params(params_from_flat(flat, "cpu"))


def _close(j, t, tol):
    j = np.asarray(j)
    t = t.detach().numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= tol * scale, np.abs(j - t).max() / scale


# ------------------------------------------------- the kernel's plain version

def _ref_latent(q_lat, q_rope, ckv, k_rope, q_pos, k_pos, window, scale):
    """The reference's absorbed-decode einsums
    (``repro.models.attention.mla_decode_attention``), per query row."""
    s = (jnp.einsum("bshr,bcr->bhsc", q_lat, ckv.astype(jnp.float32))
         + jnp.einsum("bshe,bce->bhsc", q_rope, k_rope.astype(jnp.float32))
         ) * scale
    valid = (k_pos[:, None] >= 0) & (k_pos[:, None] <= q_pos[:, :, None])
    if window:
        valid = valid & (k_pos[:, None] > q_pos[:, :, None] - window)
    s = jnp.where(valid[:, None], s, jattn.NEG_INF)
    pr = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhsc,bcr->bshr", pr, ckv.astype(jnp.float32))


@pytest.mark.parametrize("case", ["decode", "verify", "window", "k_pos",
                                  "no_valid_key"])
def test_mla_attention_ref_matches_reference_einsums(case):
    rng = np.random.default_rng(7)
    b, length, h, r, rr = 3, 40, 4, 32, 16
    sq = 5 if case == "verify" else 1
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, h, r), (b, sq, h, rr), (b, length, r), (b, length, rr))]
    q_pos = (np.array([[39], [20], [7]]) + np.arange(sq)).astype(np.int32)
    k_pos = np.tile(np.arange(length, dtype=np.int32), (b, 1))
    window = 8 if case in ("window", "k_pos") else 0
    kw = {}
    if case in ("k_pos", "no_valid_key"):
        k_pos = rng.permutation(k_pos.T).T.copy()       # ring order
        k_pos[1, ::3] = -1                              # empty slots
        if case == "no_valid_key":
            k_pos[2] = -1
        kw["k_pos"] = torch.from_numpy(k_pos)
    scale = 48 ** -0.5
    want = _ref_latent(*map(jnp.asarray, arrs), jnp.asarray(q_pos),
                       jnp.asarray(k_pos), window, scale)
    got = ops.mla_attention(*map(torch.from_numpy, arrs),
                            torch.from_numpy(q_pos), window=window,
                            scale=scale, **kw)
    _close(want, got, FN_TOL)
    assert ma.mla_attention.launches == 0       # CPU: the plain version


def test_mla_attention_shape_checks():
    z = torch.zeros
    with pytest.raises(ValueError, match="latent widths"):
        ops.mla_attention(z(1, 1, 4, 32), z(1, 1, 4, 16), z(1, 8, 64),
                          z(1, 8, 16), z(1, 1, dtype=torch.int32), scale=1.0)
    with pytest.raises(ValueError, match="q_pos"):
        ops.mla_attention(z(1, 2, 4, 32), z(1, 2, 4, 16), z(1, 8, 32),
                          z(1, 8, 16), z(1, 1, dtype=torch.int32), scale=1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        ma.mla_attention(z(1, 1, 4, 32, device="meta"), z(1, 1, 4, 16),
                         z(1, 8, 32), z(1, 8, 16), z(1, 1), scale=1.0)


# ------------------------------------------------------- attention functions

def _layer_params(j, t, i=0):
    jp = jax.tree_util.tree_map(lambda a: a[i], j.params["layers"]["attn"])
    tp = {k: v[i] for k, v in t.params["layers"]["attn"].items()}
    return jp, tp


def _rope(cfg, positions):
    """cos/sin of [B,S] positions over the rope head dim, both packages."""
    jc = jL.rope_cos_sin(jnp.asarray(positions), cfg.qk_rope_head_dim,
                         cfg.rope_theta)
    tc = tL.rope_cos_sin(torch.from_numpy(positions), cfg.qk_rope_head_dim,
                         cfg.rope_theta)
    return jc, tc


def _x(rng, cfg, b, s):
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _caches(jcfg, tcfg, b, cache_len, windowed):
    return (jattn.init_kv_cache(jcfg, b, cache_len, windowed, "float32"),
            tattn.init_kv_cache(tcfg, b, cache_len, windowed, "float32",
                                "cpu"))


def _check_cache(jc, tc):
    assert jc.keys() == tc.keys()
    for key in jc:
        _close(jc[key], tc[key], FN_TOL)


# each scenario: a windowed cache or not, the prompt, then steps of
# ("append", start) with 4 new tokens -- start a scalar or per row -- or
# ("decode", positions)
SCENARIOS = {
    "plain": (False, 13, [("append", 13), ("append", [17, 14]),
                          ("decode", [21, 18])]),
    "windowed": (True, 10, [("append", 10), ("append", [14, 12]),
                            ("decode", [18, 16])]),
    "wrapped_ring": (True, 20, [("append", 20), ("decode", [24, 23])]),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_mla_functions_match_reference(pair, scenario):
    """Prefill into the cache (ring order past the window), then extends
    and a decode step: outputs and every cache leaf. The windowed
    scenarios run with a 16-row ring and window 16."""
    j, t = pair
    windowed, s, steps = SCENARIOS[scenario]
    jcfg, tcfg = j.cfg, t.cfg
    window = 0
    if windowed:
        jcfg, tcfg = jcfg.with_(sliding_window=16), tcfg.with_(
            sliding_window=16)
        window = 16
    jp, tp = _layer_params(j, t)
    rng = np.random.default_rng(11)
    b = 2
    jc, tc = _caches(jcfg, tcfg, b, 32, windowed)
    jx, tx = _x(rng, jcfg, b, s)
    pos = np.tile(np.arange(s), (b, 1))
    (jcos, jsin), (tcos, tsin) = _rope(jcfg, pos)
    jo = jattn.mla_full_attention(jp, jx, jcos, jsin, jcfg, window=window)
    to = tattn.mla_full_attention(tp, tx, tcos, tsin, tcfg, window=window)
    _close(jo, to, FN_TOL)
    jo, jc = jattn.mla_full_attention(jp, jx, jcos, jsin, jcfg,
                                      window=window, cache=jc)
    to, tc = tattn.mla_full_attention(tp, tx, tcos, tsin, tcfg,
                                      window=window, cache=tc)
    _close(jo, to, FN_TOL)
    _check_cache(jc, tc)
    for kind, at in steps:
        n = 4 if kind == "append" else 1
        jx, tx = _x(rng, jcfg, b, n)
        starts = np.broadcast_to(np.asarray(at), (b,))
        pos = (starts[:, None] + np.arange(n)).astype(np.int32)
        (jcos, jsin), (tcos, tsin) = _rope(jcfg, pos)
        if kind == "append":
            jstart = jnp.asarray(at, jnp.int32)
            tstart = torch.tensor(at) if np.ndim(at) else at
            jo, jc = jattn.mla_append_attention(jp, jx, jcos, jsin, jcfg, jc,
                                                jstart, window=window)
            to, tc = tattn.mla_append_attention(tp, tx, tcos, tsin, tcfg, tc,
                                                tstart, window=window)
        else:
            jo, jc = jattn.mla_decode_attention(
                jp, jx, jcos, jsin, jcfg, jc, jnp.asarray(starts, jnp.int32),
                window=window)
            to, tc = tattn.mla_decode_attention(
                tp, tx, tcos, tsin, tcfg, tc, torch.from_numpy(
                    np.array(starts)), window=window)
        _close(jo, to, FN_TOL)
        _check_cache(jc, tc)


def test_caller_positions_take_the_plain_path(pair):
    j, t = pair
    jp, tp = _layer_params(j, t)
    rng = np.random.default_rng(12)
    jx, tx = _x(rng, j.cfg, 1, 9)
    pos = np.arange(5, 14, dtype=np.int32)
    (jcos, jsin), (tcos, tsin) = _rope(j.cfg, pos[None])
    jo = jattn.mla_full_attention(jp, jx, jcos, jsin, j.cfg,
                                  positions=jnp.asarray(pos))
    to = tattn.mla_full_attention(tp, tx, tcos, tsin, t.cfg,
                                  positions=torch.from_numpy(pos))
    _close(jo, to, FN_TOL)


# ------------------------------------------------------------------- model

@pytest.mark.parametrize("windowed", [False, True])
def test_model_entry_points_match_reference(pair, windowed):
    j, t = pair
    jm, jp, tm, tp = j.model, j.params, t.model, t.params
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 19)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    if not windowed:
        jf, jaux = jm.forward(jp, {"tokens": jt})
        tf, taux = tm.forward(tp, {"tokens": tt})
        _close(jf, tf, LOGIT_TOL)
        assert abs(float(jaux["lb_loss"]) - float(taux["lb_loss"])) <= 1e-5
    jl, jc = jm.prefill(jp, {"tokens": jt}, cache_len=64, windowed=windowed)
    tl, tc = tm.prefill(tp, {"tokens": tt}, cache_len=64, windowed=windowed)
    _close(jl, tl, LOGIT_TOL)
    pos = np.array([19, 16], np.int32)            # ragged decode positions
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos),
                            windowed=windowed)
    td, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                            torch.from_numpy(pos), windowed=windowed)
    _close(jd, td, LOGIT_TOL)
    if windowed:
        return
    ext = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    je, jc = jm.extend(jp, jc, jnp.asarray(ext), jnp.int32(20))
    te, tc = tm.extend(tp, tc, torch.from_numpy(ext).long(), 20)
    _close(je, te, LOGIT_TOL)
    starts = np.array([26, 22], np.int32)         # per-row [B] starts
    je, jc = jm.extend(jp, jc, jnp.asarray(ext), jnp.asarray(starts))
    te, tc = tm.extend(tp, tc, torch.from_numpy(ext).long(),
                       torch.from_numpy(starts))
    _close(je, te, LOGIT_TOL)
    for key in jc:
        for leaf in ("ckv", "k_rope"):
            _close(jc[key][leaf], tc[key][leaf], LOGIT_TOL)


def test_dropless_forward_matches_reference(pair):
    """``moe_cap=None`` (the decode setting) through a whole prompt."""
    j, t = pair
    toks = np.random.default_rng(3).integers(0, 512, (2, 13)
                                             ).astype(np.int32)
    jf, _ = j.model.forward(j.params, {"tokens": jnp.asarray(toks)},
                            moe_cap=None)
    tf, _ = t.model.forward(t.params, {"tokens": torch.from_numpy(
        toks).long()}, moe_cap=None)
    _close(jf, tf, LOGIT_TOL)


# ----------------------------------------------------- bridge and configs --

def _spec_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_shapes(v, prefix + (k,)))
        return out
    return {".".join(prefix): tuple(tree.shape)}


def test_full_width_mla_leaves_match_reference_specs():
    """deepseek-v3-671b at full width: every leaf's shape from the spec
    trees (nothing allocated), the MLA leaves among them."""
    j = _spec_shapes(jbuild(get_config(ARCH)).param_specs())
    t = _spec_shapes(tbuild(tget(ARCH)).param_specs())
    assert j == t
    assert t["layers.attn.wq_b"] == (58, 1536, 128, 192)
    assert t["dense_layers.attn.wk_b"] == (3, 512, 128, 128)
    assert t["layers.attn.wkv_a"] == (58, 7168, 576)
    jc = _spec_shapes(jbuild(get_config(ARCH)).cache_specs(4, 1104))
    assert jc == _spec_shapes(tbuild(tget(ARCH)).cache_specs(4, 1104))


def test_params_from_flat_round_trips_mla_leaves(pair):
    j, t = pair
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    mla = [k for k in flat if k.split(".")[-1] in
           ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b")]
    assert len(mla) == 14                   # 7 leaves x 2 segments
    tp = params_from_flat(flat, "cpu")
    for key in mla:
        node = tp
        for part in key.split("."):
            node = node[part]
        assert tuple(node.shape) == flat[key].shape
        assert np.array_equal(node.numpy(), flat[key])


def test_checkpoint_of_deepseek_smoke_loads(pair, tmp_path):
    j, _ = pair
    save_checkpoint(str(tmp_path), j.params, step=5, shard_bytes=1 << 20)
    flat, dtypes, step = load_checkpoint(str(tmp_path))
    assert step == 5
    lvlm = LVLM.from_pretrained(ARCH, smoke=True, checkpoint=str(tmp_path),
                                device="cpu")
    toks = np.random.default_rng(4).integers(0, 512, (1, 11)
                                             ).astype(np.int32)
    jl, _ = j.model.prefill(j.params, {"tokens": jnp.asarray(toks)})
    tl, _ = lvlm.model.prefill(lvlm.params,
                               {"tokens": torch.from_numpy(toks).long()})
    _close(jl, tl, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_head_dim_matches_reference(arch):
    for smoke in (False, True):
        assert tget(arch, smoke).kv_head_dim == \
            get_config(arch, smoke).kv_head_dim


# ------------------------------------------------------ refusals, early exit

def test_compaction_refuses_mla_as_the_reference(pair):
    from repro.api import GenerationConfig as JGen
    from repro_torch.api import GenerationConfig
    j, t = pair
    with pytest.raises(ValueError) as jerr:
        j.generate([[1, 2, 3]], JGen(compression="streaming-kv"))
    with pytest.raises(ValueError) as terr:
        t.generate([[1, 2, 3]], GenerationConfig(compression="streaming-kv"))
    assert str(terr.value) == str(jerr.value)
    assert "MLA latent cache" in str(terr.value)


def test_early_exit_refuses_mla_as_the_reference(pair):
    from repro.api import GenerationConfig as JGen
    from repro_torch.api import GenerationConfig
    j, t = pair
    kw = dict(decoder="early_exit", max_new_tokens=2)
    with pytest.raises(ValueError) as jerr:
        j.generate([[1, 2, 3]], JGen(**kw))
    with pytest.raises(ValueError) as terr:
        t.generate([[1, 2, 3]], GenerationConfig(**kw))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("threshold,patience,min_layers", [
    (1.1, 2, 2), (0.0, 0, 1)])
def test_early_exit_backfill_of_latent_cache_matches_reference(
        threshold, patience, min_layers):
    """``early_exit_decode_step`` on deepseek smoke without its dense
    prefix (the reference refuses a dense-prefix MoE): firing at layer 1,
    the skipped layer's latent cache is back-filled with the exit hidden
    state through ``mla_decode_attention``, as the reference's."""
    over = dict(first_k_dense_layers=0)
    jm = jbuild(get_config(ARCH, smoke=True).with_(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tget(ARCH, smoke=True).with_(**over))
    tp = params_from_flat({k: np.asarray(v) for k, v in
                           _flatten(jp).items()}, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (1, 9)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=16)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                       cache_len=16)
    nxt = np.array([[7]], np.int32)
    kw = dict(threshold=threshold, patience=patience, min_layers=min_layers)
    jl, jc, jinfo = jee.early_exit_decode_step(jm, jp, jc, jnp.asarray(nxt),
                                               9, **kw)
    before = tc["layers"]["ckv"].clone()
    tl, tc, tinfo = tee.early_exit_decode_step(
        tm, tp, tc, torch.from_numpy(nxt).long(), 9, **kw)
    assert tinfo == jinfo and tinfo["exited"] == (threshold == 0.0)
    _close(jl, tl, LOGIT_TOL)
    for leaf in ("ckv", "k_rope"):
        _close(jc["layers"][leaf], tc["layers"][leaf], FN_TOL)
    # every layer wrote position 9, the skipped one by the back-fill
    assert bool((tc["layers"]["ckv"][:, :, 9] != before[:, :, 9])
                .any(-1).all())



@pytest.mark.parametrize("b,sq,h,length,keys", [
    (4, 1, 128, 1104, 96),       # one-query decode: 8 row tiles, 12 CTAs
    (8, 5, 128, 1104, 1120),     # the S = 5 verify: 80 row tiles, 1 CTA
    (1, 1, 128, 131072, 2016),   # a 128K-row slot: 2 row tiles, 66 CTAs
    (4, 1, 128, 20, 32),         # less than one key tile
    (2, 17, 20, 1104, 128),      # 12 row tiles of 20 heads, 9 CTAs
])
def test_tensor_core_split_fills_the_sms(b, sq, h, length, keys):
    """The tensor-core route's keys per CTA: whole key tiles, row tiles x
    CTAs within the 132 SMs of an H100 where the keys allow, at least one
    key tile a CTA."""
    split = ma.tc_split(b, sq, h, length, 132)
    assert split == keys
    tiles = b * -(-sq * h // ma.TC_ROWS)
    n = -(-length // split)
    assert split % ma.TC_KEYS == 0 and n >= 1
    assert tiles * n <= max(132, tiles)
