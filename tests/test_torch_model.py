"""The port's model against the JAX reference, through the weight bridge.

Reference params from ``Model.init(PRNGKey(0))`` reach the port as the
flattened ``a.b.c`` numpy dict of ``repro.training.checkpoint._flatten``.
Same tokens, visual embeddings and positions go through both models on
the CPU in float32; logits agree within 1e-4 of the logit scale (the
reference's sharded-vs-single-device check allows 1e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.registry import build as jbuild
from repro.training.checkpoint import _flatten, save_checkpoint
from repro_torch.configs import get_config as tget
from repro_torch.models import build as tbuild
from repro_torch.models.convert import load_checkpoint, params_from_flat

TOL = 1e-4


@pytest.fixture(scope="module", params=["qwen2-vl-2b", "phi4-mini-3.8b"])
def pair(request):
    arch = request.param
    jm = jbuild(get_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    tm = tbuild(tget(arch, smoke=True))
    return jm, jp, tm, params_from_flat(flat, "cpu"), flat


def _close(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= TOL * scale, np.abs(j - t).max() / scale


def _batch(cfg, rng, b=2, s=11, visual=True):
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": toks}
    if visual and cfg.family == "vlm":
        out["visual_embeds"] = rng.standard_normal(
            (b, cfg.num_visual_tokens, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def test_bridge_round_trips_every_leaf(pair):
    _, _, tm, tp, flat = pair
    assert sorted(_flatten(tp)) == sorted(flat)
    for k, v in _flatten(tp).items():
        assert np.array_equal(v.numpy(), flat[k])
    # the port's own spec tree has exactly the reference's leaves
    assert sorted(_flatten(tm.param_specs())) == sorted(flat)


@pytest.mark.parametrize("visual", [True, False])
def test_prefill_decode_extend_logits(pair, visual):
    jm, jp, tm, tp, _ = pair
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    batch = _batch(cfg, rng, visual=visual)
    jl, jc = jm.prefill(jp, _j(batch), cache_len=64)
    tl, tc = tm.prefill(tp, _t(batch), cache_len=64)
    _close(jl, tl)
    _close(jc["layers"]["k"], tc["layers"]["k"])
    last_t, _ = tm.prefill(tp, _t(batch), cache_len=64, last_only=True)
    _close(np.asarray(jl)[:, -1:], last_t)

    s = batch["tokens"].shape[1] + (cfg.num_visual_tokens
                                    if "visual_embeds" in batch else 0)
    pos = np.array([s, s - 3], np.int32)          # ragged decode positions
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
    td, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                            torch.from_numpy(pos))
    _close(jd, td)

    ext = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    je, jc = jm.extend(jp, jc, jnp.asarray(ext), jnp.int32(s + 1))
    te, tc = tm.extend(tp, tc, torch.from_numpy(ext).long(), s + 1)
    _close(je, te)
    starts = np.array([s + 6, s + 2], np.int32)   # per-row [B] starts
    je, jc = jm.extend(jp, jc, jnp.asarray(ext), jnp.asarray(starts))
    te, tc = tm.extend(tp, tc, torch.from_numpy(ext).long(),
                       torch.from_numpy(starts))
    _close(je, te)
    _close(jc["layers"]["v"], tc["layers"]["v"])


def test_forward_logits(pair):
    jm, jp, tm, tp, _ = pair
    batch = _batch(jm.cfg, np.random.default_rng(1))
    jl, _ = jm.forward(jp, _j(batch))
    tl, _ = tm.forward(tp, _t(batch))
    _close(jl, tl)


def test_windowed_cache_and_custom_positions_on_cpu(pair):
    """Paths kept off the kernels (ring caches, caller positions) still
    match the reference on CPU tensors."""
    jm, jp, tm, tp, _ = pair
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    batch = _batch(cfg, rng, visual=False, s=80)    # overflows the window
    jl, jc = jm.prefill(jp, _j(batch), cache_len=96, windowed=True)
    tl, tc = tm.prefill(tp, _t(batch), cache_len=96, windowed=True)
    _close(jl, tl)
    assert np.array_equal(np.asarray(jc["layers"]["slot_pos"]),
                          tc["layers"]["slot_pos"].numpy())
    pos = np.array([80, 80], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos),
                           windowed=True)
    td, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                           torch.from_numpy(pos), windowed=True)
    _close(jd, td)
    positions = np.tile(np.arange(3, 14, dtype=np.int32), (2, 1))
    batch = dict(_batch(cfg, rng, visual=False), positions=positions)
    jl, _ = jm.prefill(jp, _j(batch), cache_len=32)
    tl, _ = tm.prefill(tp, _t(batch), cache_len=32)
    _close(jl, tl)


def test_checkpoint_round_trip(pair, tmp_path):
    """A reference checkpoint (manifest + npz shards) loads with numpy
    alone and gives the reference's logits."""
    jm, jp, tm, _, _ = pair
    save_checkpoint(str(tmp_path), jp, step=3, shard_bytes=1 << 20)
    flat, dtypes, step = load_checkpoint(str(tmp_path))
    assert step == 3
    tp = params_from_flat(flat, "cpu", dtypes=dtypes)
    batch = _batch(jm.cfg, np.random.default_rng(3))
    jl, _ = jm.prefill(jp, _j(batch))
    tl, _ = tm.prefill(tp, _t(batch))
    _close(jl, tl)
    from repro_torch.api import LVLM
    arch = {"qwen2-vl-smoke": "qwen2-vl-2b",
            "phi4-mini-smoke": "phi4-mini-3.8b"}[jm.cfg.name]
    lvlm = LVLM.from_pretrained(arch, smoke=True, checkpoint=str(tmp_path),
                                device="cpu")
    tl, _ = lvlm.model.prefill(lvlm.params, _t(batch))
    _close(jl, tl)


def test_bfloat16_checkpoint_loads():
    from repro_torch.models.convert import _to_tensor
    x = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32), jnp.bfloat16)
    raw = np.asarray(x)
    t = _to_tensor(raw)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(x, np.float32))
    # an npz read without ml_dtypes yields 2-byte voids; the manifest's
    # dtype name restores the type
    t2 = _to_tensor(raw.view(np.dtype("V2")), "bfloat16")
    assert torch.equal(t2, t)
