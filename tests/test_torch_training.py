"""The port's training substrate against the JAX reference, on the CPU.

Optimizer math, data determinism and checkpoints as the reference's own
unit tests (``tests/test_training.py``) check them, then against the
reference on the same inputs: ``adamw_update`` within 1e-6, ``make_batch``
bit for bit, float32 checkpoints loading across the two packages,
``train_loop``'s loss and resume, a 5-step loss curve from one
checkpoint, and the analytic roofline. ``Model.loss`` and its gradients
are ``tests/test_torch_train_grads*.py``'s."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import SyntheticDataConfig as JSyntheticDataConfig
from repro.training import adamw_init as j_adamw_init
from repro.training import adamw_update as j_adamw_update
from repro.training import load_checkpoint as j_load_checkpoint
from repro.training import save_checkpoint as j_save_checkpoint
from repro.training import train_loop as j_train_loop
from repro.training.checkpoint import _flatten
from repro.training.data import make_batch as j_make_batch
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models.convert import params_from_flat
from repro_torch.training import (OptimizerConfig, SyntheticDataConfig,
                                  adamw_init, adamw_update, cosine_lr,
                                  global_norm, load_checkpoint,
                                  save_checkpoint, train_loop)
from repro_torch.training.data import make_batch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread for these tests: the loop tests run
    thousands of small ops, and with several test workers sharing the
    cores torch's pool spins (the resume test took 170 s in a 6-worker
    run of the suite on 8 cores, 4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in _flatten(tree).items()}


# ------------------------------------------------------------ optimizer --

def test_cosine_lr_schedule():
    oc = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=110,
                         min_lr_frac=0.1)
    assert float(cosine_lr(oc, 0)) == 0.0
    np.testing.assert_allclose(float(cosine_lr(oc, 10)), 1e-3, rtol=1e-5)
    assert float(cosine_lr(oc, 5)) == pytest.approx(5e-4)
    np.testing.assert_allclose(float(cosine_lr(oc, 110)), 1e-4, rtol=1e-5)
    vals = [float(cosine_lr(oc, s)) for s in range(10, 111, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    jc = JOptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=110,
                          min_lr_frac=0.1)
    from repro.training import cosine_lr as j_cosine_lr
    for s in range(0, 130, 7):
        assert float(cosine_lr(oc, s)) == pytest.approx(
            float(j_cosine_lr(jc, s)), rel=1e-6)


def test_adamw_first_step_is_signed_lr():
    """With bias correction, |update| == lr / (1 + eps') on step 1."""
    oc = OptimizerConfig(lr=0.1, weight_decay=0.0, clip_norm=0.0,
                         warmup_steps=0, total_steps=1, min_lr_frac=1.0)
    params = {"w": torch.tensor([[1.0, -2.0]])}
    grads = {"w": torch.tensor([[0.5, -0.25]])}
    before = params["w"].clone()
    new_params, _, _ = adamw_update(oc, grads, adamw_init(params), params)
    delta = (before - new_params["w"]).numpy()
    np.testing.assert_allclose(np.abs(delta), 0.1, rtol=1e-4)
    np.testing.assert_allclose(np.sign(delta), np.sign(grads["w"].numpy()))


def test_grad_clipping():
    oc = OptimizerConfig(lr=0.1, clip_norm=1.0, weight_decay=0.0,
                         warmup_steps=0, total_steps=1, min_lr_frac=1.0)
    params = {"w": torch.zeros((4,))}
    grads = {"w": torch.full((4,), 100.0)}
    _, opt2, m = adamw_update(oc, grads, adamw_init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    np.testing.assert_allclose(opt2["mu"]["w"].numpy(),
                               0.1 * 100.0 * (1.0 / 200.0), rtol=1e-4)


def test_weight_decay_only_on_matrices():
    oc = OptimizerConfig(lr=0.1, weight_decay=0.5, clip_norm=0.0,
                         warmup_steps=0, total_steps=1, min_lr_frac=1.0)
    params = {"mat": torch.ones((2, 2)), "vec": torch.ones((2,))}
    grads = {"mat": torch.zeros((2, 2)), "vec": torch.zeros((2,))}
    new_params, _, _ = adamw_update(oc, grads, adamw_init(params), params)
    assert float(new_params["mat"][0, 0]) < 1.0    # decayed
    assert float(new_params["vec"][0]) == 1.0      # not decayed


def test_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(tree)) == pytest.approx(5.0)


def _random_tree(rng):
    return {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                  "b": rng.standard_normal((5,)).astype(np.float32)},
            "emb": rng.standard_normal((3, 4, 2)).astype(np.float32),
            "s": rng.standard_normal((1,)).astype(np.float32)}


def test_adamw_update_matches_reference():
    """Three steps on the same random tree and gradients (the second with
    clipping active): params, mu and nu within 1e-6, the metrics too."""
    rng = np.random.default_rng(0)
    p0 = _random_tree(rng)
    grads = [{k: {kk: vv * s for kk, vv in v.items()} if isinstance(v, dict)
              else v * s for k, v in _random_tree(rng).items()}
             for s in (0.3, 5.0, 0.1)]
    kw = dict(lr=0.05, weight_decay=0.1, clip_norm=1.0, warmup_steps=1,
              total_steps=5)
    oc, jc = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    tp = params_from_flat(_flatten(p0), "cpu")
    jp = jax.tree.map(jnp.asarray, p0)
    to, jo = adamw_init(tp), j_adamw_init(jp)
    for g in grads:
        tp, to, tm = adamw_update(oc, params_from_flat(_flatten(g), "cpu"),
                                  to, tp)
        jp, jo, jm = j_adamw_update(jc, jax.tree.map(jnp.asarray, g), jo, jp)
        for t_tree, j_tree in ((tp, jp), (to["mu"], jo["mu"]),
                               (to["nu"], jo["nu"])):
            t_np, j_np = _np(t_tree), _np(j_tree)
            for k in j_np:
                np.testing.assert_allclose(t_np[k], j_np[k], rtol=0,
                                           atol=1e-6, err_msg=k)
        assert int(to["step"]) == int(jo["step"])
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_adamw_update_writes_params_and_moments_in_place():
    """The update returns the given params and moments, changed (the
    counterpart of the reference's donated buffers), and a new step."""
    params = {"b": torch.ones((3,)), "w": torch.ones((2, 3),
                                                     dtype=torch.bfloat16)}
    opt = adamw_init(params)
    ptrs = [t.data_ptr() for t in (params["b"], params["w"], opt["mu"]["w"],
                                   opt["nu"]["b"])]
    grads = {"b": torch.full((3,), 0.5), "w": torch.full((2, 3), -0.5,
                                                         dtype=torch.bfloat16)}
    new, opt2, _ = adamw_update(OptimizerConfig(lr=0.1, warmup_steps=0),
                                grads, opt, params)
    assert [t.data_ptr() for t in (new["b"], new["w"], opt2["mu"]["w"],
                                   opt2["nu"]["b"])] == ptrs
    assert float(params["b"][0]) < 1.0 and float(params["w"][0, 0]) > 1.0
    assert float(opt["mu"]["w"][0, 0]) < 0.0 and float(opt["nu"]["b"][0]) > 0
    assert int(opt["step"]) == 0 and int(opt2["step"]) == 1


def test_adamw_bf16_params_keep_float32_moments():
    params = {"w": torch.ones((3, 3), dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt["mu"]["w"].dtype == torch.float32
    new, opt, _ = adamw_update(OptimizerConfig(), {"w": torch.ones_like(
        params["w"])}, opt, params)
    assert new["w"].dtype == torch.bfloat16
    assert opt["nu"]["w"].dtype == torch.float32


# ----------------------------------------------------------------- data --

@settings(max_examples=10, deadline=None)
@given(step=st.integers(0, 500))
def test_data_pipeline_deterministic_and_seekable(step):
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    dc = SyntheticDataConfig(batch=2, seq_len=16, seed=7)
    a = make_batch(cfg, dc, step)
    b = make_batch(cfg, dc, step)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].min() >= 0
    assert a["tokens"].max() < cfg.vocab_size
    assert a["loss_mask"][:, -1].sum() == 0


def test_vlm_batch_has_visual_embeds():
    cfg = get_config("qwen2-vl-2b", smoke=True)
    b = make_batch(cfg, SyntheticDataConfig(batch=2, seq_len=8), 0)
    assert b["visual_embeds"].shape == (2, cfg.num_visual_tokens,
                                        cfg.d_model)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-tiny",
                                  "phi4-mini-3.8b"])
def test_make_batch_bit_identical_to_reference(arch):
    for step in (0, 3, 17):
        kw = dict(batch=3, seq_len=12, seed=5)
        got = make_batch(get_config(arch, smoke=True),
                         SyntheticDataConfig(**kw), step)
        want = j_make_batch(jget(arch, smoke=True),
                            JSyntheticDataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------- checkpoint --

def test_checkpoint_shard_roundtrip():
    tree = {"a": {"b": torch.arange(100, dtype=torch.float32).reshape(10, 10),
                  "c": torch.ones((3,), dtype=torch.int32)},
            "d": torch.tensor(2.5)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, tree, step=5, shard_bytes=128)
        got, step = load_checkpoint(d, "cpu")
        assert step == 5
        assert len([f for f in os.listdir(d) if f.endswith(".npz")]) > 1
        for k, v in _np(tree).items():
            np.testing.assert_array_equal(v, _np(got)[k])


def _ckpt_tree(rng):
    return {"params": _random_tree(rng),
            "opt_state": {"step": np.asarray(3, np.int32),
                          "mu": {"x": rng.standard_normal((4, 4)).astype(
                              np.float32)}}}


def test_port_checkpoint_loads_in_reference():
    tree = _ckpt_tree(np.random.default_rng(1))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params_from_flat(_flatten(tree), "cpu"), step=7,
                        shard_bytes=200)
        got, step = j_load_checkpoint(d)
    assert step == 7
    want, got = _flatten(tree), _np(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_reference_checkpoint_loads_in_port():
    tree = _ckpt_tree(np.random.default_rng(2))
    with tempfile.TemporaryDirectory() as d:
        j_save_checkpoint(d, jax.tree.map(jnp.asarray, tree), step=9,
                          shard_bytes=200)
        got, step = load_checkpoint(d, "cpu")
    assert step == 9
    want, got = _flatten(tree), _np(got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_bf16_leaf_round_trips_in_port():
    w = torch.randn(5, 3).to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        manifest = save_checkpoint(d, {"w": w, "s": torch.tensor(1)}, step=1)
        got, _ = load_checkpoint(d, "cpu")
    assert manifest["keys"]["w"]["dtype"] == "bfloat16"
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)


# ----------------------------------------------------------------- loop --

def _phi4():
    return build(get_config("phi4-mini-3.8b", smoke=True).with_(
        vocab_size=128))


def test_loss_decreases_and_resume_matches():
    model = _phi4()
    dc = SyntheticDataConfig(batch=4, seq_len=24)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=14)
    logs = []
    with tempfile.TemporaryDirectory() as d:
        out = train_loop(model, oc=oc, dc=dc, num_steps=14, ckpt_dir=d,
                         ckpt_every=7, log_every=5, log_fn=logs.append,
                         device="cpu")
        assert out["final_loss"] < out["first_loss"]
        assert [ln.split()[1] for ln in logs] == ["0", "5", "10", "13"]
        _, step = load_checkpoint(d, "cpu")
        assert step == 14
        # the mid checkpoint: 7 steps, then resume to 14
        mid = os.path.join(d, "mid")
        train_loop(model, oc=oc, dc=dc, num_steps=7, ckpt_dir=mid,
                   ckpt_every=7, log_every=0, device="cpu")
        out2 = train_loop(model, oc=oc, dc=dc, num_steps=14, ckpt_dir=mid,
                          resume=True, log_every=0, device="cpu")
    assert out2["steps"] == 7
    np.testing.assert_allclose(out2["loss_curve"], out["loss_curve"][7:],
                               rtol=1e-3)
    assert out2["final_loss"] == pytest.approx(out["final_loss"], rel=1e-3)


def test_train_loop_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        train_loop(_phi4(), num_steps=1)


def test_loss_curve_matches_reference_from_one_checkpoint():
    """Both loops resume from one float32 checkpoint of the reference's
    init at step 0 and take 5 steps on the same batches: losses within
    1e-4 relative. The params are not compared: AdamW divides each
    gradient entry by its own root mean square, so an entry whose
    gradient is near 0 moves by up to lr on rounding noise."""
    cfg = jget("phi4-mini-3.8b", smoke=True).with_(vocab_size=128)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(3))
    dc = dict(batch=2, seq_len=16)
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    with tempfile.TemporaryDirectory() as d:
        j_save_checkpoint(d, {"params": jp, "opt_state": j_adamw_init(jp)},
                          step=0)
        want = j_train_loop(jm, oc=JOptimizerConfig(**oc),
                            dc=JSyntheticDataConfig(**dc), num_steps=5,
                            ckpt_dir=d, resume=True, log_every=0)
        got = train_loop(_phi4(), oc=OptimizerConfig(**oc),
                         dc=SyntheticDataConfig(**dc), num_steps=5,
                         ckpt_dir=d, resume=True, log_every=0, device="cpu")
    assert got["steps"] == want["steps"] == 5
    np.testing.assert_allclose(got["loss_curve"], want["loss_curve"],
                               rtol=1e-4)


# ------------------------------------------------------------- roofline --

@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "deepseek-v3-671b",
                                  "zamba2-1.2b", "whisper-tiny", "rwkv6-3b",
                                  "arctic-480b"])
def test_analytic_roofline_matches_reference(arch):
    """The port's analytic FLOPs and bytes equal the reference's for every
    assigned shape (and the training shape of the card check)."""
    from repro.configs import SHAPES as J_SHAPES
    from repro.roofline.analytic import summary as j_summary
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.roofline.analytic import summary
    from repro_torch.roofline.hw import H100_SXM
    from repro.configs.base import ShapeConfig as JShapeConfig
    assert sorted(SHAPES) == sorted(J_SHAPES)
    for sc in list(SHAPES.values()) + [ShapeConfig("train_card", 1088, 4,
                                                   "train")]:
        jsc = JShapeConfig(sc.name, sc.seq_len, sc.global_batch, sc.kind)
        assert summary(get_config(arch), sc) == j_summary(jget(arch), jsc)
    assert H100_SXM.peak_flops_bf16 == 989e12 and H100_SXM.hbm_bw == 3.35e12
