"""The flash attention gradient of the port against two references.

``flash_attention_bwd_plain`` (the closed form the backward kernel
computes) is held against ``torch.autograd`` through
``flash_attention_plain`` and against ``jax.grad`` of the reference's
``blockwise_sdpa`` (the function the reference trains through), on the
same numpy inputs, within 1e-5 of the largest gradient (float32). The
wrapper's routes are checked on the CPU: with grad it runs
``FlashAttentionFn`` (its forward keeps the log-sum-exp, its backward
launches the backward kernel on a device tensor), without grad the single
forward launch; the decode kernels refuse a differentiable call off the
CPU. The card itself is ``test_torch_cuda.py``'s."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blockwise_sdpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mla_attention as ma
from repro_torch.kernels import paged_attention as pa

TOL = 1e-5

# (name, shape b/h/kvh/sq/sk/d, kwargs of flash_attention)
CASES = [
    ("causal", (2, 4, 2, 40, 40, 32), {}),
    ("window", (1, 4, 2, 40, 40, 32), dict(window=7)),
    ("non_causal_sq_ne_sk", (1, 4, 2, 24, 40, 32), dict(causal=False)),
    ("non_causal_kv_len", (1, 4, 1, 24, 40, 32),
     dict(causal=False, kv_len=20)),
    ("kv_len_lt_sk", (1, 4, 2, 16, 40, 32), dict(kv_len=30)),
    ("keyless_rows", (1, 4, 2, 20, 40, 32), dict(q_offset=-5)),
    ("window_keyless_tail", (1, 2, 1, 30, 30, 32),
     dict(window=4, kv_len=12, q_offset=3)),
    ("scale_d192", (1, 2, 2, 24, 24, 192), dict(scale=0.07)),
    ("group_8", (1, 8, 1, 33, 33, 32), dict(window=9)),
]


def _inputs(shape, seed):
    b, h, kvh, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, do


def _plain(q, k, v, do, kw):
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o = fa.flash_attention_plain(qt, kt, vt, **kw)
    lse = fa.flash_attention_lse_plain(qt, kt, **kw)
    return fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, **kw)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_autograd(name, shape, kw):
    q, k, v, do = _inputs(shape, 0)
    got = _plain(q, k, v, do, kw)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention_plain(qt, kt, vt, **kw)
    o.backward(torch.from_numpy(do))
    for g, t, what in zip(got, (qt, kt, vt), "qkv"):
        _close(g.numpy(), t.grad.numpy(), f"{name} d{what}")


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_blockwise_sdpa(name, shape, kw):
    """jax.grad of blockwise_sdpa over one block of all Sk keys (so a
    keyless row averages the same keys as the flash function): the
    kv_len mask is k_pos = -1, the offset q_pos = arange(Sq) + q_offset,
    the scale a factor on q (blockwise_sdpa scales by 1/sqrt(D))."""
    b, h, kvh, sq, sk, d = shape
    q, k, v, do = _inputs(shape, 1)
    causal = kw.get("causal", True)
    kv_len, q_offset = fa.resolve_offsets(sq, sk, causal, kw.get("kv_len"),
                                          kw.get("q_offset", 0))
    q_pos = jnp.arange(sq, dtype=jnp.int32) + q_offset
    k_pos = jnp.where(jnp.arange(sk) < kv_len, jnp.arange(sk), -1
                      ).astype(jnp.int32)
    factor = kw["scale"] * d ** 0.5 if "scale" in kw else 1.0
    g = h // kvh

    def to_j(x):           # [B,N,S,D] -> [B,S,N,D]
        return jnp.asarray(x.transpose(0, 2, 1, 3))

    def loss(qj, kj, vj):
        o = blockwise_sdpa((qj * factor).reshape(b, sq, kvh, g, d), kj, vj,
                           q_pos=q_pos, k_pos=k_pos, causal=causal,
                           window=kw.get("window", 0), block_k=sk)
        return jnp.sum(o * to_j(do))
    want = jax.grad(loss, argnums=(0, 1, 2))(to_j(q), to_j(k), to_j(v))
    got = _plain(q, k, v, do, kw)
    for gj, gt, what in zip(want, got, "qkv"):
        _close(gt.numpy(), np.asarray(gj).transpose(0, 2, 1, 3),
               f"{name} d{what}")


def test_cpu_wrapper_takes_the_autograd_route():
    q, k, v, do = _inputs((1, 4, 2, 20, 20, 32), 2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, window=5)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(torch.from_numpy(do))
    want = _plain(q, k, v, do, dict(window=5))
    for t, w in zip((qt, kt, vt), want):
        assert torch.equal(t.grad, w)
    with torch.no_grad():
        assert fa.flash_attention(qt, kt, vt).grad_fn is None
    assert fa.flash_attention(qt.detach(), kt.detach(),
                              vt.detach()).grad_fn is None


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' device-tensor route on ``meta`` tensors: the device
    check passes, the kernels' C entries record their arguments instead of
    launching, and the stream is 0 (``meta`` otherwise takes the plain
    version, as the dry run's shape-only stand-ins do)."""
    calls = {"fwd": [], "bwd": []}
    monkeypatch.setattr(fa, "plain_device", _cpu_only)
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(fa, "_lib", lambda: (
        lambda *a: calls["fwd"].append(a) or 0))
    monkeypatch.setattr(fa, "_bwd_lib", lambda: (
        lambda *a: calls["bwd"].append(a) or 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _cpu_only(t):
    return t.device.type == "cpu"


def _meta(shape, grad):
    return torch.empty(shape, device="meta").requires_grad_(grad)


def test_device_wrapper_runs_autograd_function(fake_card):
    fwd0, bwd0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    q, k, v = (_meta(s, True) for s in ((2, 4, 64, 32), (2, 2, 64, 32),
                                        (2, 2, 64, 32)))
    out = fa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert fake_card["fwd"][-1][4] is not None        # lse requested
    out.sum().backward()
    assert len(fake_card["bwd"]) == 1
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert fa.flash_attention.launches == fwd0 + 1
    assert fa.flash_attention_bwd.launches == bwd0 + 1
    with torch.no_grad():                             # the serving launch
        fa.flash_attention(q, k, v)
    assert fake_card["fwd"][-1][4] is None
    assert fa.flash_attention.launches == fwd0 + 2
    assert len(fake_card["bwd"]) == 1


def test_device_wrapper_passes_v_width(fake_card):
    """A v narrower than q and k (MLA's prefill) reaches the C entry as its
    own width, and the output has it; the autograd route refuses it."""
    q = _meta((1, 4, 40, 192), False)
    k, v = _meta((1, 4, 40, 192), False), _meta((1, 4, 40, 128), False)
    out = fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, scale=0.07)
    a = fake_card["fwd"][-1]
    assert a[5:12] == (1, 4, 4, 40, 40, 192, 128)   # B H KVH Sq Sk D Dv
    assert out.shape == (1, 4, 40, 128) and out.transpose(1, 2).is_contiguous()
    with pytest.raises(ValueError):
        fa.flash_attention(q.requires_grad_(), k, v)


def test_decode_kernels_refuse_a_gradient_off_the_cpu(monkeypatch):
    # ``meta`` stands in for a card tensor here
    monkeypatch.setattr(pa, "plain_device", _cpu_only)
    monkeypatch.setattr(ma, "plain_device", _cpu_only)
    q = _meta((2, 4, 32), True)
    pages = _meta((4, 16, 2, 32), False)
    table = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    seqs = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="no backward"):
        pa.paged_attention(q, pages, pages, table, seqs)
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_attention(q.detach(), pages, pages, table, seqs)
    q_lat = _meta((2, 1, 4, 32), True)
    q_rope = _meta((2, 1, 4, 16), False)
    ckv, k_rope = _meta((2, 8, 32), False), _meta((2, 8, 16), False)
    pos = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="no backward"):
        ma.mla_attention(q_lat, q_rope, ckv, k_rope, pos, scale=0.1)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="unsupported device"):
        ma.mla_attention(q_lat, q_rope, ckv, k_rope, pos, scale=0.1)
