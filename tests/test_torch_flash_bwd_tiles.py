"""The flash backward's tensor-core route, modelled on the CPU.

``_tile_model`` repeats, in plain PyTorch, the arithmetic of the bf16
``wgmma`` route of ``csrc/flash_attention_bwd.cu``: bf16 inputs; per
64-key tile of a (batch, kv head, q-head group) the group's q heads and
q tiles in order, S^T and dP^T in float32, P^T = exp2(S^T scale log2e -
lse log2e) and dS^T = P^T (dP^T - delta), each rounded to bf16 where the
kernel rounds it (the A operands of dV += P^T dO and dK += dS^T Q), sums
in float32; the keyless rows' dO / Sk added to dV; the groups' float32
shares summed in group order; per 64-row q tile the key tiles in order
for dQ += dS K; results rounded to bf16. It is held against ``jax.grad``
of the reference's ``blockwise_sdpa`` on the same numpy inputs, within
``chip_smoke.py``'s bf16 bars (1e-2 of the largest gradient, each element
within max(3e-2, 2^-7 |x|)): the design's rounding meets the card's bars
before the card runs it. Above ``BWD_HILO_G`` q heads a kv head the
kernel splits P^T and dS^T into bf16 hi + lo parts: the model shows that
one rounding misses the bars at G 48 and the split meets them. The
wrapper's route, group and scratch choices are checked at the shapes the
card runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blockwise_sdpa
from repro_torch.kernels import flash_attention as fa

TILE = fa.BWD_TILE
LOG2E = 1.4426950408889634
REL_TOL, ABS_TOL, ULP = 1e-2, 3e-2, 2.0 ** -7


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _operand(x, hilo):
    """An A operand of the products as the kernel feeds it: bf16, or bf16
    hi + bf16 lo (two products, summed in float32)."""
    hi = _bf16(x)
    return hi + _bf16(x - hi) if hilo else hi


def _visible(sq, sk, causal, window, kv_len, q_offset):
    """[Sq, Sk]: True where the query sees the key."""
    qp = torch.arange(sq)[:, None] + q_offset
    kp = torch.arange(sk)[None]
    ok = kp < min(kv_len, sk)
    if causal:
        ok = ok & (kp <= qp)
        if window:
            ok = ok & (kp > qp - window)
    return ok.expand(sq, sk)


def _tile_model(q, k, v, o, lse, do, *, causal, window, kv_len, q_offset,
                scale, splits, hilo=False):
    """(dq, dk, dv) as the wgmma route computes them; q, o, do [B,H,Sq,D]
    and k, v [B,KVH,Sk,D] float32 holding bf16 values, lse [B,H,Sq]."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    gs = g // splits
    vis = _visible(sq, sk, causal, window, kv_len, q_offset)
    keyless = ~vis.any(-1)
    lse2 = lse * LOG2E
    delta = (do * o).sum(-1)
    sl2 = scale * LOG2E
    q_tiles = range(0, sq, TILE)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        for kh in range(kvh):
            for k0 in range(0, sk, TILE):
                kt, vt = k[bi, kh, k0:k0 + TILE], v[bi, kh, k0:k0 + TILE]
                shares = []
                for grp in range(splits):
                    ak = torch.zeros_like(kt)
                    av = torch.zeros_like(vt)
                    heads = range(kh * g + grp * gs, kh * g + (grp + 1) * gs)
                    for hh in heads:
                        for q0 in q_tiles:
                            qs = slice(q0, q0 + TILE)
                            qt, dot = q[bi, hh, qs], do[bi, hh, qs]
                            m = vis[qs, k0:k0 + TILE].T
                            pt = torch.where(m, torch.exp2(
                                kt @ qt.T * sl2 - lse2[bi, hh, qs][None]), 0.0)
                            av += _operand(pt, hilo) @ dot
                            dst = pt * (vt @ dot.T - delta[bi, hh, qs][None])
                            ak += _operand(dst, hilo) @ qt
                    if keyless.any():
                        rows = do[bi, list(heads)][:, keyless]
                        av += rows.sum((0, 1)) * (1.0 / sk)
                    shares.append((ak * scale, av))
                dk[bi, kh, k0:k0 + TILE] = sum(s[0] for s in shares)
                dv[bi, kh, k0:k0 + TILE] = sum(s[1] for s in shares)
    dq = torch.empty_like(q)
    for bi in range(b):
        for hh in range(h):
            kt_all, vt_all = k[bi, hh // g], v[bi, hh // g]
            for q0 in q_tiles:
                qs = slice(q0, q0 + TILE)
                qt, dot = q[bi, hh, qs], do[bi, hh, qs]
                acc = torch.zeros_like(qt)
                for k0 in range(0, sk, TILE):
                    kt = kt_all[k0:k0 + TILE]
                    m = vis[qs, k0:k0 + TILE]
                    p = torch.where(m, torch.exp2(
                        qt @ kt.T * sl2 - lse2[bi, hh, qs][:, None]), 0.0)
                    ds = p * (dot @ vt_all[k0:k0 + TILE].T
                              - delta[bi, hh, qs][:, None])
                    acc += _bf16(ds) @ kt
                dq[bi, hh, qs] = acc * scale
    return _bf16(dq), _bf16(dk), _bf16(dv)


# (name, b/h/kvh/sq/sk/d, flash kwargs, q-head groups a kv head): JAX
# compiles each case once (~1 s), so each covers several edges
CASES = [
    # rows before position 0 (keyless), keys past kv_len, explicit scale
    ("causal_keyless_kv_len_scale", (1, 2, 1, 70, 90, 32),
     dict(q_offset=-20, kv_len=75, scale=0.07), 1),
    ("non_causal_sq_ne_sk", (1, 2, 2, 24, 90, 64),
     dict(causal=False, kv_len=70), 1),
    ("group_6_two_groups", (2, 12, 2, 72, 72, 32), {}, 2),
    ("group_8_four_groups_window", (1, 8, 1, 66, 66, 64), dict(window=30),
     4),
]


def _inputs(shape, seed):
    """bf16-valued float32 arrays q, k, v, dO ([B,N,S,D])."""
    b, h, kvh, sq, sk, d = shape
    rng = np.random.default_rng(seed)

    def draw(*s):
        x = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        return _bf16(x).numpy()
    return (draw(b, h, sq, d), draw(b, kvh, sk, d), draw(b, kvh, sk, d),
            draw(b, h, sq, d))


def _jax_grads(q, k, v, do, kw):
    """jax.grad of blockwise_sdpa over one block of all Sk keys, as in
    test_torch_flash_grad.py ([B,N,S,D] in and out)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    causal = kw.get("causal", True)
    kv_len, q_offset = fa.resolve_offsets(sq, sk, causal, kw.get("kv_len"),
                                          kw.get("q_offset", 0))
    q_pos = jnp.arange(sq, dtype=jnp.int32) + q_offset
    k_pos = jnp.where(jnp.arange(sk) < kv_len, jnp.arange(sk), -1
                      ).astype(jnp.int32)
    factor = kw["scale"] * d ** 0.5 if "scale" in kw else 1.0

    def to_j(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3))

    def loss(qj, kj, vj):
        o = blockwise_sdpa((qj * factor).reshape(b, sq, kvh, h // kvh, d),
                           kj, vj, q_pos=q_pos, k_pos=k_pos, causal=causal,
                           window=kw.get("window", 0), block_k=sk)
        return jnp.sum(o * to_j(do))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(to_j(q), to_j(k),
                                                       to_j(v))
    return [np.asarray(x).transpose(0, 2, 1, 3) for x in grads]


@pytest.mark.parametrize("name,shape,kw,splits", CASES,
                         ids=[c[0] for c in CASES])
def test_tile_model_meets_the_bf16_bars(name, shape, kw, splits):
    q, k, v, do = _inputs(shape, 3)
    want = _jax_grads(q, k, v, do, kw)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    causal = kw.get("causal", True)
    kv_len, q_offset = fa.resolve_offsets(shape[3], shape[4], causal,
                                          kw.get("kv_len"),
                                          kw.get("q_offset", 0))
    o = _bf16(fa.flash_attention_plain(qt, kt, vt, **kw))
    lse = fa.flash_attention_lse_plain(qt, kt, **kw)
    for hilo in (False, True):
        got = _tile_model(qt, kt, vt, o, lse, dot, causal=causal,
                          window=kw.get("window", 0), kv_len=kv_len,
                          q_offset=q_offset,
                          scale=kw.get("scale", shape[5] ** -0.5),
                          splits=splits, hilo=hilo)
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            assert _over_bars(g.numpy(), w) == (0, False), (name, hilo, what)


def _over_bars(got, want):
    """(elements over max(ABS_TOL, ULP |x|), whether the largest error
    exceeds REL_TOL of the largest gradient)."""
    diff = np.abs(got - want)
    return (int((diff > np.maximum(ABS_TOL, ULP * np.abs(want))).sum()),
            bool(diff.max() > REL_TOL * np.abs(want).max()))


def test_group_48_needs_the_hi_lo_operands():
    """At G 48 (granite-34b: 48 q heads over one kv head) one bf16
    rounding of P^T and dS^T, summed over 48 heads' rows into each dK and
    dV element, puts elements over the bars (against the float32 plain
    backward); the hi + lo operands the kernel takes above BWD_HILO_G
    meet them. 24 groups of 2 heads, as the wrapper picks on 132 SMs."""
    assert 6 <= fa.BWD_HILO_G < 48
    b, h, kvh, s, d = 1, 48, 1, 100, 128
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs((b, h, kvh, s, s, d), 22))
    o = _bf16(fa.flash_attention_plain(q, k, v))
    lse = fa.flash_attention_lse_plain(q, k)
    want = [_bf16(x).numpy()
            for x in fa.flash_attention_bwd_plain(q, k, v, o, lse, do)]
    kw = dict(causal=True, window=0, kv_len=s, q_offset=0, scale=d ** -0.5,
              splits=24)
    one = _tile_model(q, k, v, o, lse, do, **kw)
    two = _tile_model(q, k, v, o, lse, do, hilo=True, **kw)
    assert any(_over_bars(g.numpy(), w)[0] for g, w in zip(one[1:], want[1:]))
    for g, w in zip(two, want):
        assert _over_bars(g.numpy(), w) == (0, False)


def test_route_groups_and_scratch_at_the_card_shapes():
    """bf16 at D 32 / 64 / 128 takes wgmma, float32 and D 192 fma; the
    dK / dV groups at FLASH_BWD_CASES' shapes on 132 SMs; the scratch the
    wrapper allocates for each route."""
    assert [fa.bwd_route(torch.bfloat16, d) for d in fa.HEAD_DIMS] == \
        ["wgmma", "wgmma", "wgmma", "fma"]
    assert {fa.bwd_route(torch.float32, d) for d in fa.HEAD_DIMS} == {"fma"}
    assert fa.bwd_splits(4, 2, 6, 1088, 132) == 3      # training shape
    assert fa.bwd_splits(1, 1, 48, 1056, 132) == 24    # G 48
    assert fa.bwd_splits(1, 2, 4, 1056, 132) == 4      # D 32, G 4
    assert fa.bwd_splits(1, 32, 1, 1024, 132) == 1     # window, G 1
    b, h, kvh, sq, sk, d = 4, 12, 2, 1088, 1088, 128
    assert fa.bwd_scratch_floats("wgmma", b, h, kvh, sq, sk, d, 2) == \
        2 * b * h * 1088 + 2 * b * kvh * 2 * sk * d
    assert fa.bwd_scratch_floats("wgmma", b, h, kvh, 70, sk, d, 1) == \
        2 * b * h * 128
    assert fa.bwd_scratch_floats("fma", b, h, kvh, sq, sk, d, 1) == \
        b * h * sq + 2 * b * h * sk * d
    assert fa.bwd_scratch_floats("fma", 1, 1, 1, 3, 5, 32, 1) == \
        64 + 2 * 5 * 32
